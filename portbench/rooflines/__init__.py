"""The operations and bytes of one call of each kernel wrapper of the
program, one module per wrapper, named as the wrapper's profiler range.

Each module has ``ops(k, n, block)`` and ``bytes_moved(k, n, block)``
for a call over ``k`` lanes of ``n`` real rows (``block``: the band
block of B5; the others ignore it).  They count what the work needs at
the real n, not at the pad the program runs: a factorization is n³/3
operations (a multiply and an add each count one), a triangular solve
of one vector n², each input array is read once and each output array
written once, float32.
"""
