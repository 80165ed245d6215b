"""Multi-device support of the port: the sharding rules
(``distributed/sharding.py``), the HE schedule's collectives
(``distributed/collectives.py``) and fault tolerance
(``distributed/fault.py``)."""
