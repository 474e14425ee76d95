"""Hierarchical semantic tree machinery (a port-owned copy of
``hierslam_tpu/datasets/tree.py``, numpy only).

* Replica: parse ``info_semantic_tree.json`` — each entry ``"<id>_<name>"``
  maps to a per-level list of ``{level_id: level_name}`` dicts
  (datasets/gradslam_datasets/replica.py:630-674);
* ScanNet: parse the tree TSVs — NYU40-keyed 4-level tree from columns
  17-24 of ``scannetv2-labels.combined.tree.tsv``
  (scannet.py:719-795) and raw-id-keyed 5-level tree from columns 17-26 of
  the ``tree-large`` TSV (scannet.py:875-966), plus the raw->NYU40 map from
  column 4 (scannet.py:575-599);
* per-level one-hot encoding of a tree label stack (label2map_tree_new,
  scripts/hierslam.py:1436-1486) and per-level label-image remapping.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def read_tree_annotation(annotations: Dict, tree_level: int = 5):
    """Replica tree JSON -> (mapping {base_id_str: level-id tuple},
    per-level {id-tuple: name} dicts + base {id: name})."""
    mapping: Dict[str, Tuple[int, ...]] = {}
    info_level: List[Dict] = [dict() for _ in range(tree_level)]
    base: Dict[int, str] = {}
    for key, item in annotations.items():
        base_id, base_name = key.split("_", 1)
        base[int(base_id)] = base_name
        ids = [-1] * tree_level
        for i_level, level_info in enumerate(item):
            for k in level_info:
                ids[i_level] = int(k)
        for i_level, level_info in enumerate(item):
            for k, name in level_info.items():
                info_level[i_level][tuple(ids[: i_level + 1])] = name
        mapping[base_id] = tuple(ids)
    info_level.append(base)
    return mapping, info_level


def find_max_level(mapping: Dict[str, Sequence[int]], add_one: bool = True) -> List[int]:
    """Per-level class counts (max id (+1)) — replica.py:677-691."""
    arr = np.asarray(list(mapping.values()))
    return [int(arr[:, i].max()) + (1 if add_one else 0) for i in range(arr.shape[1])]


def load_replica_tree(path: str, tree_level: int = 5):
    """Load info_semantic_tree.json; returns (mapping, info_level,
    num_semantic list [per-level counts..., num_leaf])."""
    with open(path, "r") as f:
        annotations = json.load(f)
    mapping, info_level = read_tree_annotation(annotations, tree_level)
    num_semantic = find_max_level(mapping, add_one=True)
    num_semantic.append(len(mapping))
    return mapping, info_level, num_semantic


def remap_levels(label: np.ndarray, mapping: Dict, num_levels: int) -> np.ndarray:
    """[H, W] base-id label image -> [num_levels+1, H, W] per-level stack
    (last row = original ids), via a dense lookup table.

    Ids absent from the mapping keep their original value at every level —
    the same fall-through the reference's masked in-place assignment
    produces (replica.py:241-254)."""
    keys = np.asarray([int(k) for k in mapping.keys()])
    max_id = max(int(label.max()), int(keys.max())) + 1
    lut = np.tile(np.arange(max_id, dtype=np.int64)[:, None], (1, num_levels))
    for k, ids in mapping.items():
        lut[int(k)] = np.asarray(ids)
    lab = np.clip(label.astype(np.int64), 0, max_id - 1)
    out = np.empty((num_levels + 1,) + label.shape, dtype=np.int32)
    for lv in range(num_levels):
        out[lv] = lut[lab, lv]
    out[num_levels] = label
    return out


def tree_onehot(label_stack: np.ndarray, num_semantic: Sequence[int]) -> np.ndarray:
    """[L+1, H, W] per-level int labels -> concatenated per-level one-hot
    [sum(num_semantic[:-1]), H, W] (label2map_tree_new)."""
    per_level = num_semantic[:-1]
    maps = []
    for lv, n_cls in enumerate(per_level):
        lab = label_stack[lv]
        oh = (lab[None] == np.arange(n_cls)[:, None, None]).astype(np.float32)
        maps.append(oh)
    return np.concatenate(maps, 0)


def flat_onehot(label: np.ndarray, num_classes: int) -> np.ndarray:
    """[H, W] -> [num_classes, H, W] one-hot (label2map,
    scripts/hierslam.py:1384-1405)."""
    return (label[None] == np.arange(num_classes)[:, None, None]).astype(np.float32)


# --- ScanNet TSV parsers ---------------------------------------------------

def load_scannet_raw_to_nyu40(tsv_path: str) -> Dict[int, int]:
    """scannet raw id (col 0) -> nyu40 id (col 4)."""
    mapping = {}
    with open(tsv_path) as f:
        for i, line in enumerate(csv.reader(f, delimiter="\t")):
            if i == 0:
                continue
            mapping[int(line[0])] = int(line[4])
    return mapping


def _level_cols(line: List[str], pairs: List[Tuple[int, int]]):
    ids, names = [], []
    for id_col, name_col in pairs:
        if id_col > len(line) - 1 or line[id_col] == "":
            ids.append(None)
            names.append(None)
        else:
            ids.append(int(line[id_col]))
            names.append(line[name_col])
    return ids, names


def load_scannet_tree(tsv_path: str, levels: int = 4, key: str = "nyu40"):
    """Parse the hierarchical columns of a scannet tree TSV.

    ``key='nyu40'`` keys the mapping by the NYU40 id (col 4) with
    ``levels=4`` (cols 17-24) — scannet.py:719-795; ``key='raw'`` keys by
    the raw scannet id (col 0) with ``levels=5`` (cols 17-26) —
    scannet.py:875-966.  Missing deeper levels fall back to the last
    present id so remapping never injects sentinel values.
    """
    pairs = [(17 + 2 * i, 18 + 2 * i) for i in range(levels)]
    mapping: Dict[int, Tuple[int, ...]] = {}
    names: Dict[str, Tuple] = {}
    names_by_id: Dict[int, str] = {}
    with open(tsv_path) as f:
        for i, line in enumerate(csv.reader(f, delimiter="\t")):
            if i == 0:
                continue
            ids, level_names = _level_cols(line, pairs)
            last = 0
            ids_filled = []
            for v in ids:
                last = v if v is not None else last
                ids_filled.append(last)
            k = int(line[4]) if key == "nyu40" else int(line[0])
            mapping[k] = tuple(ids_filled)
            label_col = 7 if key == "nyu40" else 1
            names[line[label_col]] = tuple(level_names)
            names_by_id[k] = line[label_col]
    mapping = dict(sorted(mapping.items()))
    return mapping, names, names_by_id


NYU40_CLASS_NAMES = [
    "void", "wall", "floor", "cabinet", "bed", "chair", "sofa", "table",
    "door", "window", "bookshelf", "picture", "counter", "blinds", "desk",
    "shelves", "curtain", "dresser", "pillow", "mirror", "floor",
    "clothes", "ceiling", "books", "fridge", "tv", "paper", "towel",
    "shower curtain", "box", "white board", "person", "night stand",
    "toilet", "sink", "lamp", "bath tub", "bag", "other struct",
    "other furniture", "other prop",
]


def label_colormap(n: int = 256) -> np.ndarray:
    """PASCAL-style bit-interleaved label colormap (imgviz.label_colormap
    equivalent, used for semantic visualization)."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap
