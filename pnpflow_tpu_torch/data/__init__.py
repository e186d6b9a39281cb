from pnpflow_tpu_torch.data.datasets import DataLoaders, synthetic_images

__all__ = ["DataLoaders", "synthetic_images"]
