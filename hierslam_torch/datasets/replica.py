"""Replica dataset loaders, plain, semantic-tree and v2 (port of
``hierslam_tpu/datasets/replica.py``).

Directory contract:
* ``results/frame*.jpg`` / ``results/depth*.png`` and per-line c2w poses in
  ``traj.txt``;
* the semantic variant also reads ``semantic_class/semantic_class_*.png``
  and the hierarchy ``info_semantic_tree.json``, remapping each base-class
  id to its per-level tree ids lazily per frame through a dense LUT.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np

from hierslam_torch.datasets import tree as tree_lib
from hierslam_torch.datasets.base import RGBDDataset, natsorted
from hierslam_torch.utils.image_io import read_image


class ReplicaDataset(RGBDDataset):
    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_path = os.path.join(self.input_folder, "traj.txt")
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        depth = natsorted(glob.glob(f"{self.input_folder}/results/depth*.png"))
        return color, depth

    def load_poses(self):
        with open(self.pose_path, "r") as f:
            lines = f.readlines()
        return [
            np.array(list(map(float, lines[i].split()))).reshape(4, 4)
            for i in range(self.num_imgs)
        ]


class ReplicaSemanticDataset(ReplicaDataset):
    """Replica + per-frame semantic labels (``sem_mode``: 'tree' or
    'original').

    Exposes what the SLAM driver and the eval read: ``num_semantic`` (list
    of per-level counts + leaf count for tree mode; int for flat),
    ``num_semantic_class`` (leaf count), ``sem_mode``,
    ``label_mapping_tree`` and ``colors_map_all``.
    """

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.sem_mode = config_dict.get("sem_mode", "tree")
        self.num_tree_level = config_dict.get("num_tree_level", 5)
        self.dataset_name = config_dict["dataset_name"]
        basedir_sem = config_dict.get("basedir_sem", basedir)
        self.input_folder_sem = os.path.join(basedir_sem, sequence)
        super().__init__(config_dict, basedir, sequence, **kwargs)

        paths = natsorted(
            glob.glob(f"{self.input_folder_sem}/semantic_class/semantic_class_*.png")
        )
        self.semantic_paths = [paths[i] for i in self.retained_inds]
        if len(self.semantic_paths) != self.num_imgs:
            raise ValueError(f"{len(self.semantic_paths)} label images for {self.num_imgs} "
                             "frames")

        if self.sem_mode == "original":
            with open(os.path.join(self.input_folder_sem, "info_semantic.json")) as f:
                annotations = json.load(f)
            classes = {item["id"]: item["name"] for item in annotations["classes"]}
            classes[0] = "void"
            self.semantic_class = [classes[k] for k in sorted(classes)]
            self.num_semantic = len(self.semantic_class)
            self.num_semantic_class = self.num_semantic
            self.colors_map_all = tree_lib.label_colormap(max(self.num_semantic, 256))
            self.label_mapping_tree = None
        elif "tree" in self.sem_mode:
            mapping, info_level, num_semantic = tree_lib.load_replica_tree(
                os.path.join(self.input_folder_sem, "info_semantic_tree.json"),
                self.num_tree_level,
            )
            self.label_mapping_tree = mapping
            self.tree_id_classes_map = info_level
            self.num_semantic = num_semantic
            self.num_semantic_class = num_semantic[-1]
            self.colors_map_all = tree_lib.label_colormap(max(self.num_semantic_class, 256))
        else:
            raise ValueError(f"unknown sem_mode {self.sem_mode}")

    def load_label(self, index: int) -> np.ndarray:
        """-> [n_maps, H, W] int32 (tree: levels+original; flat: 1 row)."""
        raw = np.asarray(read_image(self.semantic_paths[index]), dtype=np.int64)
        raw = self._preprocess_label(raw)
        if self.sem_mode == "original":
            return raw[None].astype(np.int32)
        return tree_lib.remap_levels(raw, self.label_mapping_tree, self.num_tree_level)

    def __getitem__(self, index: int):
        color, depth, K4, pose = super().__getitem__(index)
        return color, depth, K4, pose, self.load_label(index)


class ReplicaV2Dataset(ReplicaDataset):
    """ReplicaV2 (imap splits): train split in ``imap/00``, eval split in
    ``imap/01``; poses in ``traj_w_c.txt``."""

    def __init__(self, config_dict, basedir, sequence, use_train_split=True, **kwargs):
        self.use_train_split = use_train_split
        split = "imap/00" if use_train_split else "imap/01"
        self.input_folder = os.path.join(basedir, sequence, split)
        self.pose_path = os.path.join(self.input_folder, "traj_w_c.txt")
        RGBDDataset.__init__(self, config_dict, **kwargs)

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/rgb/rgb_*.png"))
        depth = natsorted(glob.glob(f"{self.input_folder}/depth/depth_*.png"))
        return color, depth
