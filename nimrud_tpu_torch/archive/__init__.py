from nimrud_tpu_torch.archive import io, store
from nimrud_tpu_torch.archive.store import CloudArchive

__all__ = ["CloudArchive", "io", "store"]
