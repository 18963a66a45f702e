"""The train step's observability switches (counterpart of the two
readers in ``distributed_embeddings_tpu/utils/obs.py`` that
``make_hybrid_train_step`` and ``make_hybrid_train_loop`` call). Both
are read when a step is BUILT."""

from __future__ import annotations

from . import envvars

OBS_ENV = "DETPU_OBS"
NANGUARD_ENV = "DETPU_NANGUARD"


def metrics_enabled() -> bool:
    """Whether ``DETPU_OBS`` asks for step metrics."""
    return envvars.enabled(OBS_ENV)


def nanguard_enabled() -> bool:
    """Whether the on-device non-finite guard is on. Default ON
    (``DETPU_NANGUARD`` unset or truthy); ``DETPU_NANGUARD=0`` builds the
    unguarded step."""
    return envvars.enabled(NANGUARD_ENV)
