"""Port of ``ray_tpu/accelerators/accelerator.py``.

AcceleratorManager ABC (reference: python/ray/_private/accelerators/accelerator.py)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional


class AcceleratorManager(ABC):
    @abstractmethod
    def get_resource_name(self) -> str:
        """The resource key this accelerator advertises (e.g. 'TPU')."""

    @abstractmethod
    def get_current_node_num_accelerators(self) -> int:
        """Number of accelerator units physically present on this node."""

    def get_current_node_additional_resources(self) -> Dict[str, float]:
        """Extra resources (e.g. TPU pod head/name resources for gang scheduling)."""
        return {}

    def get_visible_accelerator_ids_env_var(self) -> Optional[str]:
        """Env var used to restrict a worker to specific units."""
        return None

    def set_visible_accelerator_ids(self, env: Dict[str, str], ids: List[str]) -> None:
        var = self.get_visible_accelerator_ids_env_var()
        if var:
            env[var] = ",".join(ids)
