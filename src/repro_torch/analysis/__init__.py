"""The lock hierarchy, the runtime lock watchdog, the interleaving explorer and the lint of the storage core.

Copies of :mod:`repro.analysis.lock_order` (the declared global lock
hierarchy) and :mod:`repro.analysis.lockwatch` (the opt-in runtime watchdog,
``REPRO_LOCKWATCH=1``), which :mod:`repro_torch.core` imports at module
load, and of :mod:`repro.analysis.schedules` (the deterministic interleaving
explorer; its scenario builders import :mod:`repro_torch.core` lazily), and
of :mod:`repro.analysis.lint` (the static lock-discipline lint, which checks
this package against the same hierarchy).

This package must stay import-light: nothing here may import
``repro_torch.core``.
"""

from repro_torch.analysis import lock_order  # noqa: F401
from repro_torch.analysis.lockwatch import (  # noqa: F401
    enabled,
    make_condition,
    make_lock,
    watch,
)
