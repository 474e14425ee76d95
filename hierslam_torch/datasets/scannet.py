"""ScanNet loaders, plain and semantic (port of
``hierslam_tpu/datasets/scannet.py``).

Directory contract (gradslam's ``scannet.py``): ``color/*.jpg``,
``depth/*.png`` (millimetres, ``png_depth_scale`` 1000), one c2w pose per
frame in ``pose/*.txt``.  The semantic variant reads the raw-id label
images ``label-filt/*.png`` (16-bit) and remaps them lazily per frame
through lookup tables:

* ``nyu40``: raw id -> NYU40 (column 4 of ``scannetv2-labels.combined.tsv``),
  41 flat classes;
* ``tree``: NYU40 -> the 4 levels of ``scannetv2-labels.combined.tree.tsv``;
* ``tree_large``: raw id -> the 5 levels of
  ``scannetv2-labels.combined.tree-large.tsv``, whose leaf row is the dense
  index of the raw id among the TSV's ids (``semantic_id``): the eval maps
  both prediction and ground truth back to raw ids and scores them by id
  (``eval/runner.py``).

The label TSVs are read from ``labels_tsv_dir`` (default: ``basedir``);
the raw -> NYU40 TSV is looked for in the sequence's folder first.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from hierslam_torch.datasets import tree as tree_lib
from hierslam_torch.datasets.base import RGBDDataset, natsorted
from hierslam_torch.utils.image_io import read_image

# NYU40 label colour code (the palette of ScanNet's tooling).
NYU40_COLOUR_CODE = np.array(
    [
        (0, 0, 0), (174, 199, 232), (152, 223, 138), (31, 119, 180), (255, 187, 120),
        (188, 189, 34), (140, 86, 75), (255, 152, 150), (214, 39, 40), (197, 176, 213),
        (148, 103, 189), (196, 156, 148), (23, 190, 207), (178, 76, 76), (247, 182, 210),
        (66, 188, 102), (219, 219, 141), (140, 57, 197), (202, 185, 52), (51, 176, 203),
        (200, 54, 131), (92, 193, 61), (78, 71, 183), (172, 114, 82), (255, 127, 14),
        (91, 163, 138), (153, 98, 156), (140, 153, 101), (158, 218, 229), (100, 125, 154),
        (178, 127, 135), (120, 185, 128), (146, 111, 194), (44, 160, 44), (112, 128, 144),
        (96, 207, 209), (227, 119, 194), (213, 92, 176), (94, 106, 211), (82, 84, 163),
        (100, 85, 144),
    ],
    dtype=np.uint8,
)


class ScannetDataset(RGBDDataset):
    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/color/*.jpg"))
        depth = natsorted(glob.glob(f"{self.input_folder}/depth/*.png"))
        return color, depth

    def load_poses(self):
        files = natsorted(glob.glob(f"{self.input_folder}/pose/*.txt"))
        return [np.loadtxt(p) for p in files]


class ScannetSemanticDataset(ScannetDataset):
    """ScanNet with per-frame labels; ``sem_mode`` is ``nyu40``, ``tree``
    (4 levels over NYU40, 16 channels for ScanNet's TSV) or ``tree_large``
    (5 levels over raw ids, 74 channels over about 550 leaves)."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.sem_mode = config_dict.get("sem_mode", "nyu40")
        self.dataset_name = config_dict["dataset_name"]
        self.input_folder = os.path.join(basedir, sequence)
        tsv_dir = config_dict.get("labels_tsv_dir", basedir)

        raw_tsv = os.path.join(self.input_folder, "scannetv2-labels.combined.tsv")
        if not os.path.isfile(raw_tsv):
            raw_tsv = os.path.join(tsv_dir, "scannetv2-labels.combined.tsv")
        self.raw_to_nyu40 = tree_lib.load_scannet_raw_to_nyu40(raw_tsv)
        self._raw_lut = None      # raw id -> NYU40, built at the first label

        if self.sem_mode == "nyu40":
            self.num_semantic = 41
            self.num_semantic_class = 41
            self.tree_mapping = None
            self.num_levels = 0
        elif self.sem_mode == "tree":
            mapping, _, _ = tree_lib.load_scannet_tree(
                os.path.join(tsv_dir, "scannetv2-labels.combined.tree.tsv"), levels=4,
                key="nyu40")
            self.tree_mapping = mapping
            counts = tree_lib.find_max_level({str(k): v for k, v in mapping.items()})
            self.num_semantic = counts + [41]
            self.num_semantic_class = 41
            self.num_levels = 4
        elif self.sem_mode == "tree_large":
            mapping, _, names_by_id = tree_lib.load_scannet_tree(
                os.path.join(tsv_dir, "scannetv2-labels.combined.tree-large.tsv"), levels=5,
                key="raw")
            self.tree_mapping = mapping
            counts = tree_lib.find_max_level({str(k): v for k, v in mapping.items()})
            self.num_semantic = counts + [len(mapping)]
            self.num_semantic_class = len(mapping)
            self.num_levels = 5
            # dense leaf index i <-> raw id semantic_id[i], in raw-id order
            self.semantic_id = list(mapping.keys())
            self.semantic_class = [names_by_id[k] for k in self.semantic_id]
            self._raw_to_dense = np.zeros(max(self.semantic_id) + 1, dtype=np.int64)
            self._raw_to_dense[self.semantic_id] = np.arange(len(self.semantic_id))
        else:
            raise ValueError(f"unknown sem_mode {self.sem_mode}")
        self.colour_map_np = NYU40_COLOUR_CODE

        super().__init__(config_dict, basedir, sequence, **kwargs)
        paths = natsorted(glob.glob(f"{self.input_folder}/label-filt/*.png"))
        self.label_paths = [paths[i] for i in self.retained_inds]
        if len(self.label_paths) != self.num_imgs:
            raise ValueError(f"{len(self.label_paths)} label images for {self.num_imgs} frames")

    def _nyu40_lut(self) -> np.ndarray:
        if self._raw_lut is None:
            lut = np.zeros(max(self.raw_to_nyu40) + 1, dtype=np.int64)
            lut[list(self.raw_to_nyu40)] = list(self.raw_to_nyu40.values())
            self._raw_lut = lut
        return self._raw_lut

    def load_label(self, index: int) -> np.ndarray:
        """-> [levels + 1, H, W] int32 (nyu40: [1, H, W])."""
        raw = np.asarray(read_image(self.label_paths[index]), dtype=np.int64)
        raw = self._preprocess_label(raw)
        if self.sem_mode == "tree_large":
            # the leaf row becomes the dense index of the raw id (so that the
            # decoder's [num_leaf] logits index safely); eval maps it back
            out = tree_lib.remap_levels(raw, self.tree_mapping, self.num_levels)
            out[-1] = self._raw_to_dense[np.clip(out[-1], 0, len(self._raw_to_dense) - 1)]
            return out
        lut = self._nyu40_lut()
        nyu = lut[np.clip(raw, 0, len(lut) - 1)]
        if self.sem_mode == "nyu40":
            return nyu[None].astype(np.int32)
        return tree_lib.remap_levels(nyu, self.tree_mapping, self.num_levels)

    def __getitem__(self, index: int):
        color, depth, K4, pose = super().__getitem__(index)
        return color, depth, K4, pose, self.load_label(index)
