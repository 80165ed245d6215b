"""Fault tolerance of the port (``distributed/fault.py``).  The
multi-device schedule (the reference's ``sharding.py``) is not ported."""
