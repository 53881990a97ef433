"""The port's invariant checkers over its own tree (``src/repro_torch``).

The counterpart of ``repro.analysis``, in its layout, importing neither JAX
nor the JAX package.  ``python -m repro_torch.analysis`` is the CLI;
``run_checks`` / ``CHECKERS`` are the library surface; suppressions are
``# repro: allow-<check>  <why>`` pragmas (``analysis.pragmas``), spelled
as in the JAX package.

Importing this package populates the registry:

=====================  ==================================================
``unfused-dispatch``   solver products route through ``kernels.ops``; no
                       unfused minplus, no accumulate sweeps, no
                       full-matrix copies (tier A, AST)
``semiring-hardcode``  no literal tropical ops in semiring-parametrized
                       modules (tier A, AST)
``host-sync``          no host sync or clock read on the per-round and
                       per-launch path (tier A, AST; the counterpart of
                       ``trace-impurity``)
``autotune-key``       lookup parameters reach the cache key, call sites
                       bind every key axis (tier A, AST)
``donation``           no read of a donated name; donating solves return
                       the caller's storage, the engine keeps its own,
                       ``rkleene`` never aliases (tier A + tier B)
``except-swallow``     failure-path handlers re-raise, transition, defer
                       or record (tier A, AST, *advisory*)
``kernel-grid``        the CUDA kernels' launch plans: race free, in
                       bounds, covering, matching the oracle over the
                       shape lattice; on a card, the kernels themselves
                       (tier B)
=====================  ==================================================
"""

from .base import CHECKERS, Checker, Finding, Project, register_checker, run_checks
from . import dispatch as _dispatch            # noqa: F401  (registers)
from . import semiring_hardcode as _semiring   # noqa: F401
from . import purity as _purity                # noqa: F401
from . import autotune_key as _autotune        # noqa: F401
from . import donation as _donation            # noqa: F401
from . import except_swallow as _swallow       # noqa: F401
from . import kernelcheck as _kernelcheck      # noqa: F401
from .donation import DonationSpec, run_donation_checks

__all__ = [
    "CHECKERS",
    "Checker",
    "Finding",
    "Project",
    "register_checker",
    "run_checks",
    "DonationSpec",
    "run_donation_checks",
]
