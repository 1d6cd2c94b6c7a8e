"""Loader for the MATLAB-generated ESKF virtual sensor fixtures (a numpy
copy of `lego_loam_tpu/io/eskf_data.py`, which the port cannot import
without jax).

≙ `ESKF::loadFromJson` (myESKF.cpp:753-884): IMUData/LidarData/EncoderData/
GroundTruthData JSON files, read from any directory that holds them (the
fixtures ship with the reference repo, not with this one;
`io.synthetic.synth_eskf_fixture` writes consistent streams in the same
format).
"""

from __future__ import annotations

import json
import os

import numpy as np


def available(data_dir: str) -> bool:
    return os.path.isfile(os.path.join(data_dir, "IMUData.json"))


def load(data_dir: str):
    def rd(name, key):
        with open(os.path.join(data_dir, f"{name}.json")) as f:
            return {k: np.asarray(v, np.float64) for k, v in json.load(f)[key].items()}

    imu = rd("IMUData", "IMUData")
    lidar = rd("LidarData", "LidarData")
    enc = rd("EncoderData", "EncoderData")
    gt = rd("GroundTruthData", "GTData")
    return {
        "acc_mea": imu["Acc_mea"],
        "omega_mea": imu["Omega_mea"],
        "acc_gt": imu["Acc_GT"],
        "omega_gt": imu["Omega_GT"],
        "lidar_pos": lidar["Position_mea"],
        "lidar_rpy": lidar["Attitude_mea"],
        "lidar_pos_gt": lidar["Position_GT"],
        "lidar_rpy_gt": lidar["Attitude_GT"],
        "vel_count": enc["vel_count_mea"].reshape(-1),
        "steer_count": enc["steer_count_mea"].reshape(-1),
        "gt_pos": gt["pos"],
        "gt_vel": gt["vel"],
        "gt_att": gt["att"],
    }


def quaternion_noise_scale(lidar_rpy_gt, lidar_rpy_mea):
    """Per-component std of quaternion measurement error
    (≙ LidarMeasurementQuaNoiseScale, myESKF.cpp:157-204)."""
    def to_q(rpy):
        r, p, y = rpy[:, 0], rpy[:, 1], rpy[:, 2]
        cy, sy = np.cos(y / 2), np.sin(y / 2)
        cp, sp = np.cos(p / 2), np.sin(p / 2)
        cr, sr = np.cos(r / 2), np.sin(r / 2)
        return np.stack(
            [
                cr * cp * cy + sr * sp * sy,
                sr * cp * cy - cr * sp * sy,
                cr * sp * cy + sr * cp * sy,
                cr * cp * sy - sr * sp * cy,
            ],
            axis=1,
        )

    dq = to_q(lidar_rpy_gt) - to_q(lidar_rpy_mea)
    return dq.std(axis=0, ddof=1)


def load_reference_output(path: str):
    """The reference's committed fused-trajectory output (Fusion_Pose_Data.txt),
    or None where the file is absent."""
    if not os.path.isfile(path):
        return None
    return np.loadtxt(path)
