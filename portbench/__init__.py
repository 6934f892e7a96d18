"""The benchmark of gtsam_personal_tpu_torch on one or more CUDA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See README.md beside this file.
"""
