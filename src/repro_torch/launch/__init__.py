"""The serving tier of the PyTorch port, ported from ``repro.launch``: the
supervised engine pool (``pool``), its fault injector (``faults``),
background update executor (``executor``) and locked counters
(``stats``).  The serving driver is ``python -m repro_torch.launch.serve``
(not imported here, so that ``-m`` runs it as the entry module)."""

from .executor import UpdateExecutor
from .faults import NULL_INJECTOR, FaultInjector, FaultSpec, InjectedCrash
from .pool import EnginePool, EngineSlot, QueryResult, SlotState
from .stats import Counters

__all__ = [
    "Counters",
    "EnginePool",
    "EngineSlot",
    "FaultInjector",
    "FaultSpec",
    "InjectedCrash",
    "NULL_INJECTOR",
    "QueryResult",
    "SlotState",
    "UpdateExecutor",
]
