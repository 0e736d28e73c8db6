"""Sharding rules (``distributed/sharding.py``) and the fault-tolerance
policies the serving health layer reuses (``distributed/fault.py``)."""
