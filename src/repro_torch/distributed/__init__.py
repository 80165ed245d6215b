"""Multi-device support of the port: the sharding rules
(``distributed/sharding.py``, with the LM's placements), the
collectives of the HE and LM schedules
(``distributed/collectives.py``) and fault tolerance
(``distributed/fault.py``)."""
