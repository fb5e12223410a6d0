"""Metric readers: ``read(record, **params)`` returns a metric's value from
a run's record, or None where the record has nothing to read."""
