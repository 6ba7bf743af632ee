"""Graph factories."""

from grafx_tpu_torch.models.console import Console, bench_console

__all__ = ["Console", "bench_console"]
