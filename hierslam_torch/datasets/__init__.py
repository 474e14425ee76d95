"""Dataset registry + dispatch (port of ``hierslam_tpu/datasets/__init__.py``).

The registry keeps the JAX package's names.  The Replica and ScanNet
loaders are ported; the other loaders raise ``NotImplementedError``
(ROADMAP.md, queue 1 path 6)."""
from __future__ import annotations

from hierslam_torch.datasets.base import RGBDDataset, load_dataset_config, natsorted  # noqa: F401
from hierslam_torch.datasets.replica import (  # noqa: F401
    ReplicaDataset,
    ReplicaSemanticDataset,
    ReplicaV2Dataset,
)
from hierslam_torch.datasets.scannet import ScannetDataset, ScannetSemanticDataset  # noqa: F401

_REGISTRY = {
    "replica": ReplicaDataset,
    "replica_semantic": ReplicaSemanticDataset,
    "replicav2": ReplicaV2Dataset,
    "scannet": ScannetDataset,
    "scannet_semantic": ScannetSemanticDataset,
}
_NOT_PORTED = ("icl", "azure", "azurekinect", "ai2thor", "record3d", "realsense", "tum",
               "scannetpp", "nerfcapture")


def get_dataset(config_dict, basedir, sequence, **kwargs):
    name = config_dict["dataset_name"].lower()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"the {name} loader is not ported yet (ROADMAP.md, queue 1 path 6); "
            f"ported: {sorted(_REGISTRY)}")
    if name not in _REGISTRY:
        raise ValueError(f"Unknown dataset name {name}")
    return _REGISTRY[name](config_dict, basedir, sequence, **kwargs)
