"""gtsam_personal_tpu_torch — the PyTorch/CUDA port of gtsam_personal_tpu.

The port runs the bundle-adjustment Levenberg-Marquardt main path
(`sfm/ba_pack.py:ba_lm_run_pk`) on one NVIDIA H100, with the landmark 3x3
block solve as a hand-written CUDA kernel (`ops/block_solve.py`,
`csrc/landmark_block_solve.cu`), the pose-graph batch LM path
(`nonlinear/optimizers.py:lm_run` over `linear/schur.py:solve_partitioned`),
pose-graph SLAM from g2o/TORO files (`tools/pose_graph_g2o.py` over
`slam/dataset.py` and `slam/initialize.py`) with the factor library of
`slam/factors.py` and `slam/unstable.py`, the ISAM2 stream
(`nonlinear/isam2.py`), checkpointing (`utils/serialization.py`),
inertial navigation (`navigation/`) and smart factors (`sfm/smart.py`),
Shonan rotation averaging (`sfm/shonan.py` over `geometry/son.py`) with
translation averaging (`sfm/averaging.py`), and the nonlinear breadth
(`nonlinear/{marginals,dogleg,gnc,constrained,misc,fixed_lag,incremental,
concurrent}.py`).
The JAX package `gtsam_personal_tpu` is the
reference it is tested against; this package imports torch and never jax.

Importing the package loads nothing heavy: import the submodules you need.
"""

__version__ = "0.1.0"
