"""paddle_tpu_torch.observability — the serving engine's robustness hooks
(counterpart of ``paddle_tpu/observability``: its fault sites, the numeric
guard's inject site, the serving watchdog and SLO accounting; tracing,
the metrics registry, telemetry and the flight recorder are not ported
yet).

- :mod:`.faults` — fault injection hooks and seeded :class:`FaultPlan`\\ s;
- :mod:`.numerics` — the numeric guard's default and ``nan_inject`` site;
- :mod:`.watchdog` — :class:`~.watchdog.ServingWatchdog`;
- :mod:`.slo` — :class:`~.slo.SLOPolicy` and :class:`~.slo.SLOAccountant`.
"""

from __future__ import annotations

from . import faults, numerics, slo, watchdog  # noqa: F401
from .faults import FaultPlan  # noqa: F401
from .slo import SLOAccountant, SLOPolicy  # noqa: F401
from .watchdog import ServingWatchdog  # noqa: F401
