"""Feature stores below the device (cf. ``glt_tpu/store``): the row
codecs (:mod:`.quant`), the on-disk store and its streaming writer
(:mod:`.disk`) and the budgeted DRAM stager (:mod:`.stager`)."""
from . import quant
from .disk import (
    DATA_NAME,
    FORMAT_VERSION,
    MANIFEST_NAME,
    DiskFeatureStore,
    FeatureStoreWriter,
    StoreCorruptError,
    StoreError,
    write_feature_store,
)
from .quant import CODECS, QuantSpec, dequantize
from .stager import DramStager, publish_store_stats

__all__ = [
    "CODECS", "DATA_NAME", "DiskFeatureStore", "DramStager",
    "FORMAT_VERSION", "FeatureStoreWriter", "MANIFEST_NAME", "QuantSpec",
    "StoreCorruptError", "StoreError", "dequantize", "publish_store_stats",
    "quant", "write_feature_store",
]
