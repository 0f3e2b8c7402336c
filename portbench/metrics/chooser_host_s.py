"""Chooser layer (``choosers/GPEIOptChooser.py``, ``GPEIperSecChooser.py``):
seconds a ``next`` spends outside its step, per suggestion, over the
window's unprofiled calls: the call's wall time (host clock) less the
step's ``latency_s`` from its ``suggest`` event.  Padding the grid, the
host-to-device copies, the state file and the event."""


def read(view):
    calls = [k for k in view.window if "latency_s" in k]
    if not calls:
        return None
    return sum(k["wall_s"] - k["latency_s"] for k in calls) / len(calls)
