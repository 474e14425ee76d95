"""Dataset registry + dispatch (port of ``hierslam_tpu/datasets/__init__.py``).

The registry keeps the JAX package's names, and every loader is ported."""
from __future__ import annotations

from hierslam_torch.datasets.base import RGBDDataset, load_dataset_config, natsorted  # noqa: F401
from hierslam_torch.datasets.misc import (  # noqa: F401
    Ai2ThorDataset,
    AzureKinectDataset,
    ICLDataset,
    NeRFCaptureDataset,
    RealsenseDataset,
    Record3DDataset,
    ScannetPPDataset,
    TUMDataset,
)
from hierslam_torch.datasets.replica import (  # noqa: F401
    ReplicaDataset,
    ReplicaSemanticDataset,
    ReplicaV2Dataset,
)
from hierslam_torch.datasets.scannet import ScannetDataset, ScannetSemanticDataset  # noqa: F401

_REGISTRY = {
    "icl": ICLDataset,
    "replica": ReplicaDataset,
    "replica_semantic": ReplicaSemanticDataset,
    "replicav2": ReplicaV2Dataset,
    "azure": AzureKinectDataset,
    "azurekinect": AzureKinectDataset,
    "scannet": ScannetDataset,
    "scannet_semantic": ScannetSemanticDataset,
    "ai2thor": Ai2ThorDataset,
    "record3d": Record3DDataset,
    "realsense": RealsenseDataset,
    "tum": TUMDataset,
    "scannetpp": ScannetPPDataset,
    "nerfcapture": NeRFCaptureDataset,
}


def get_dataset(config_dict, basedir, sequence, **kwargs):
    name = config_dict["dataset_name"].lower()
    if name not in _REGISTRY:
        raise ValueError(f"Unknown dataset name {name}")
    return _REGISTRY[name](config_dict, basedir, sequence, **kwargs)
