"""Asset system (counterpart of datum_tpu/asset): the binary .pack
reader and writer with their LZ4 codec, the core pack's ids, the asset
manager that decodes on worker threads, and the uploader that puts
decoded payloads on the card on a CUDA side stream.  Packs are
byte-compatible with the JAX package's and the reference engine's."""

from .corepack import CORE_MAGIC, CORE_VERSION, CoreAsset
from .manager import AssetManager, PackWatcher
from .pack import AssetInfo, PackReader, PackWriter
from .upload import DeviceUploader

__all__ = ["AssetInfo", "AssetManager", "CORE_MAGIC", "CORE_VERSION", "CoreAsset",
           "DeviceUploader", "PackReader", "PackWatcher", "PackWriter"]
