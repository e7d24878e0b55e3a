"""Process-wide utilities: counters and timers, per-query deadlines and
the serving front door's event loop."""
