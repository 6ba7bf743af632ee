"""Graph data layer: mutable graphs, tensor form, conversion, batching."""

from grafx_tpu_torch.data.batch import batch_grafx
from grafx_tpu_torch.data.configs import UTILITY_TYPES, NodeConfigs
from grafx_tpu_torch.data.conversion import convert_to_tensor
from grafx_tpu_torch.data.graph import GRAFX
from grafx_tpu_torch.data.tensor import GRAFXTensor

__all__ = [
    "GRAFX",
    "GRAFXTensor",
    "NodeConfigs",
    "UTILITY_TYPES",
    "batch_grafx",
    "convert_to_tensor",
]
