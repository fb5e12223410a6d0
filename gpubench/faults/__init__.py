"""Faults a configuration names (its ``faults`` key): each
``<module>.py`` here holds plants of the form ``harness/faults.py``
describes, for one configuration's task."""
