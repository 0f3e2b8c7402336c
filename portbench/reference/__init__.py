"""The plain reference (``gp.py``) and the frozen golden copy it is held
to (``golden.py``).  Imports nothing of the program or of JAX."""
