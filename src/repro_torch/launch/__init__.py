"""The launchers of the PyTorch port, ported from ``repro.launch``: the
mesh constructors (``mesh``) and the serving tier, the supervised engine
pool (``pool``), its fault injector (``faults``), background update
executor (``executor``) and locked counters (``stats``).  The serving
CLI is ``python -m repro_torch.launch.serve`` (not imported here, so that
``-m`` runs it as the entry module)."""

from .executor import UpdateExecutor
from .faults import NULL_INJECTOR, FaultInjector, FaultSpec, InjectedCrash
from .mesh import make_host_mesh, make_production_mesh
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
    "make_host_mesh",
    "make_production_mesh",
]
