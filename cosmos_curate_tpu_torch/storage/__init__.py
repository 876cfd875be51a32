from cosmos_curate_tpu_torch.storage.client import (
    LocalStorageClient,
    StorageClient,
    get_storage_client,
    is_remote_path,
    read_bytes,
    write_bytes,
)

__all__ = [
    "LocalStorageClient",
    "StorageClient",
    "get_storage_client",
    "is_remote_path",
    "read_bytes",
    "write_bytes",
]
