"""Multi-rank serving: mesh axes (``axisinfo``), collectives over them
(``collectives``) and the sharding rules (``sharding``), the counterparts of
:mod:`repro.parallel`."""
