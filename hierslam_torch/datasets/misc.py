"""The other RGB-D loaders: TUM, ICL, Azure Kinect, Ai2Thor, Record3D,
RealSense, ScanNet++ (DSLR) and NeRFCapture (port of
``hierslam_tpu/datasets/misc.py``).

They differ from the base only in file layout and pose format:

* ``TUMDataset``: ``rgb.txt`` / ``depth.txt`` / ``groundtruth.txt``
  (else ``pose.txt``) associated by nearest timestamp within 0.08 s,
  capped at 32 fps; poses ``tx ty tz qx qy qz qw``; TUM's colour is
  undistorted by the base (``camera_params.distortion``);
* ``ICLDataset``: ``rgb/`` and ``depth/`` PNGs, 3x4 poses on three lines
  each of ``*.gt.sim`` (1 in the homogeneous corner);
* ``AzureKinectDataset``: ``color/*.jpg``, ``depth/*.png``, poses from a
  ``.log`` (5 lines a frame) or 16 floats a line, identity without a file;
* ``Ai2ThorDataset``: ``color/``, ``depth/`` PNGs and ``pose/*.txt``;
* ``Record3DDataset`` / ``RealsenseDataset``: ``rgb/*.png`` (``.jpg``),
  ``depth/*.png``, ``poses/*.npy``;
* ``ScannetPPDataset``: the DSLR nerfstudio ``transforms_undistorted.json``
  with ``train_test_lists.json``, OpenGL c2w turned to OpenCV, depth in mm;
* ``NeRFCaptureDataset``: ``transforms.json``, ``rgb/``, ``depth/``.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Optional

import numpy as np

from hierslam_torch.datasets.base import RGBDDataset, natsorted

_GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0])   # flip the camera's y and z axes


def _quat_pose(pvec: np.ndarray) -> np.ndarray:
    """[tx ty tz qx qy qz qw] -> 4x4 c2w."""
    from scipy.spatial.transform import Rotation

    pose = np.eye(4)
    pose[:3, :3] = Rotation.from_quat(pvec[3:]).as_matrix()
    pose[:3, 3] = pvec[:3]
    return pose


def _with_camera(config_dict, meta, png_depth_scale, height, width):
    """``config_dict`` with ``camera_params`` taken from a nerfstudio-style
    ``meta`` where it has them."""
    config_dict = dict(config_dict)
    cp = dict(config_dict.get("camera_params", {}))
    cp.update(
        png_depth_scale=png_depth_scale,
        image_height=meta.get("h", cp.get("image_height", height)),
        image_width=meta.get("w", cp.get("image_width", width)),
        fx=meta.get("fl_x", cp.get("fx", 0)),
        fy=meta.get("fl_y", cp.get("fy", 0)),
        cx=meta.get("cx", cp.get("cx", 0)),
        cy=meta.get("cy", cp.get("cy", 0)),
    )
    config_dict["camera_params"] = cp
    return config_dict


class TUMDataset(RGBDDataset):
    """TUM RGB-D: nearest-in-time rgb/depth/pose triplets within 0.08 s,
    rate-limited to 32 fps."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self._assoc = None
        super().__init__(config_dict, **kwargs)

    def _associate(self):
        if self._assoc is not None:
            return self._assoc
        folder = self.input_folder
        pose_list = os.path.join(folder, "groundtruth.txt")
        if not os.path.isfile(pose_list):
            pose_list = os.path.join(folder, "pose.txt")
        image_data = np.loadtxt(os.path.join(folder, "rgb.txt"), dtype=str)
        depth_data = np.loadtxt(os.path.join(folder, "depth.txt"), dtype=str)
        pose_data = np.loadtxt(pose_list, dtype=str, skiprows=1)
        t_img = image_data[:, 0].astype(np.float64)
        t_dep = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)

        assoc = []
        for i, t in enumerate(t_img):
            j = int(np.argmin(np.abs(t_dep - t)))
            k = int(np.argmin(np.abs(t_pose - t)))
            if abs(t_dep[j] - t) < 0.08 and abs(t_pose[k] - t) < 0.08:
                assoc.append((i, j, k))
        keep = [0]                                   # at most 32 frames a second
        for i in range(1, len(assoc)):
            if t_img[assoc[i][0]] - t_img[assoc[keep[-1]][0]] > 1.0 / 32:
                keep.append(i)
        self._assoc = ([assoc[i] for i in keep], image_data, depth_data,
                       pose_data[:, 1:].astype(np.float64))
        return self._assoc

    def get_filepaths(self):
        assoc, image_data, depth_data, _ = self._associate()
        color = [os.path.join(self.input_folder, image_data[i, 1]) for i, _, _ in assoc]
        depth = [os.path.join(self.input_folder, depth_data[j, 1]) for _, j, _ in assoc]
        return color, depth

    def load_poses(self):
        assoc, _, _, pose_vecs = self._associate()
        return [_quat_pose(pose_vecs[k]) for _, _, k in assoc]


class ICLDataset(RGBDDataset):
    """ICL-NUIM: poses from the ``*.gt.sim`` file, a 3x4 matrix on every
    three lines.  The homogeneous corner is 1 (gradslam's loader writes 3
    there)."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        sims = glob.glob(os.path.join(self.input_folder, "*.gt.sim"))
        if not sims:
            raise ValueError("Need pose file ending in `*.gt.sim`")
        self.pose_path = sims[0]
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/rgb/*.png"))
        depth = natsorted(glob.glob(f"{self.input_folder}/depth/*.png"))
        return color, depth

    def load_poses(self):
        rows = []
        with open(self.pose_path) as f:
            for line in f:
                parts = line.strip().split()
                if parts:
                    rows.append([float(v) for v in parts[:4]])
        rows = np.asarray(rows)
        poses = []
        for i in range(0, rows.shape[0], 3):
            p = np.eye(4)
            p[:3] = rows[i: i + 3]
            poses.append(p)
        return poses


class AzureKinectDataset(RGBDDataset):
    """``color/*.jpg``, ``depth/*.png``; odometry from a ``.log`` (a header
    line and 4 matrix rows a frame) or 16 floats a line; identity without
    ``odomfile``."""

    def __init__(self, config_dict, basedir, sequence, odomfile: Optional[str] = None,
                 **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_path = os.path.join(self.input_folder, odomfile) if odomfile else None
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/color/*.jpg"))
        depth = natsorted(glob.glob(f"{self.input_folder}/depth/*.png"))
        return color, depth

    def load_poses(self):
        if self.pose_path is None:
            return [np.eye(4) for _ in range(self.num_imgs)]
        with open(self.pose_path) as f:
            lines = f.readlines()
        if self.pose_path.endswith(".log"):
            return [np.array([list(map(float, lines[5 * i + 1 + r].split())) for r in range(4)])
                    .reshape(4, 4) for i in range(len(lines) // 5)]
        return [np.array(list(map(float, line.split()))).reshape(4, 4)
                for line in lines if line.split()]


class Ai2ThorDataset(RGBDDataset):
    """``color/*.png``, ``depth/*.png``, ``pose/*.txt``."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/color/*.png"))
        depth = natsorted(glob.glob(f"{self.input_folder}/depth/*.png"))
        return color, depth

    def load_poses(self):
        return [np.loadtxt(p) for p in natsorted(glob.glob(f"{self.input_folder}/pose/*.txt"))]


class Record3DDataset(RGBDDataset):
    """``rgb/*.png``, ``depth/*.png``, ``poses/*.npy``."""

    color_ext = "png"

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/rgb/*.{self.color_ext}"))
        depth = natsorted(glob.glob(f"{self.input_folder}/depth/*.png"))
        return color, depth

    def load_poses(self):
        return [np.load(p) for p in natsorted(glob.glob(f"{self.input_folder}/poses/*.npy"))]


class RealsenseDataset(Record3DDataset):
    """The Record3D layout with ``rgb/*.jpg``."""

    color_ext = "jpg"


class ScannetPPDataset(RGBDDataset):
    """ScanNet++ DSLR through nerfstudio's ``transforms_undistorted.json``:
    the frames of the train (or test) list, OpenGL c2w poses turned to
    OpenCV by flipping the camera's y and z axes, depth in mm."""

    def __init__(self, config_dict, basedir, sequence, use_train_split=True, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.use_train_split = use_train_split
        with open(f"{self.input_folder}/dslr/nerfstudio/transforms_undistorted.json") as f:
            self.meta = json.load(f)
        with open(f"{self.input_folder}/dslr/train_test_lists.json") as f:
            split = json.load(f)
        names = split["train"] if use_train_split else split["test"]
        frames = {f["file_path"]: f for f in self.meta["frames"]}
        if not use_train_split and "test_frames" in self.meta:
            frames.update({f["file_path"]: f for f in self.meta["test_frames"]})
        self.frames = [frames[n] for n in names if n in frames]
        super().__init__(_with_camera(config_dict, self.meta, 1000.0, 584, 876), **kwargs)

    def get_filepaths(self):
        base = f"{self.input_folder}/dslr"
        color = [f"{base}/undistorted_images/{f['file_path']}" for f in self.frames]
        depth = [f"{base}/undistorted_depths/{f['file_path'].replace('.JPG', '.png')}"
                 for f in self.frames]
        return color, depth

    def load_poses(self):
        return [np.array(f["transform_matrix"]) @ _GL_TO_CV for f in self.frames]


class NeRFCaptureDataset(RGBDDataset):
    """NeRFCapture: ``transforms.json``, ``rgb/``, ``depth/`` (PNG,
    ``png_depth_scale`` 6553.5), OpenGL c2w poses turned to OpenCV."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        with open(f"{self.input_folder}/transforms.json") as f:
            self.meta = json.load(f)
        self.image_names = natsorted(os.listdir(f"{self.input_folder}/rgb"))
        super().__init__(_with_camera(config_dict, self.meta, 6553.5, 720, 960), **kwargs)

    def get_filepaths(self):
        color = [f"{self.input_folder}/rgb/{n}" for n in self.image_names]
        depth = [f"{self.input_folder}/depth/"
                 f"{n.replace('.jpg', '.png').replace('.JPG', '.png')}" for n in self.image_names]
        return color, depth

    def load_poses(self):
        return [np.array(f["transform_matrix"]) @ _GL_TO_CV for f in self.meta["frames"]]
