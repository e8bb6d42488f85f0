"""Distribution layer of the port: the fault-tolerant training loop, the
straggler watchdog and deterministic fault injection (``fault.py``), on
one device.  The reference's sharding rules and ``shard_act`` wait for
the mesh port (ROADMAP queue 1, item 8)."""
from .fault import (Fault, FaultInjector, FaultTolerantLoop, LoopStats,
                    ScriptedFaultInjector, StragglerWatchdog)

__all__ = ["Fault", "FaultInjector", "FaultTolerantLoop", "LoopStats",
           "ScriptedFaultInjector", "StragglerWatchdog"]
