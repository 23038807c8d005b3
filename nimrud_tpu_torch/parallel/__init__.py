from nimrud_tpu_torch.parallel import mesh, tiles

__all__ = ["mesh", "tiles"]
