"""Port of ``ray_tpu/_lint/checkers/__init__.py``.

Checker suite — importing this package registers every checker.

Add a checker by dropping a module here that defines a
:class:`ray_tpu_torch._lint.core.Checker` subclass decorated with ``@register``,
and importing it below (explicit imports keep registration order — and
therefore reporter output — deterministic).
"""

from ray_tpu_torch._lint.checkers import (  # noqa: F401
    async_blocking,
    collective_timeout,
    config_drift,
    lock_discipline,
    metrics_hygiene,
    no_flatten,
    tracer_hygiene,
    wire_contract,
)
