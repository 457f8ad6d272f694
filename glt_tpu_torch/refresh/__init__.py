"""Layer-wise whole-graph embedding refresh (cf. ``glt_tpu/refresh``):
layer ``l`` sweeps every node partition once, gathers the previous
layer's rows for the partition plus its 1-hop frontier through the
tiered :class:`~glt_tpu_torch.data.feature.Feature`, applies one GNN
layer on the device and streams the partition's rows into a
:class:`~glt_tpu_torch.store.disk.FeatureStoreWriter`."""
from .driver import RefreshDriver, RefreshReport, sage_refresh_layers

__all__ = ["RefreshDriver", "RefreshReport", "sage_refresh_layers"]
