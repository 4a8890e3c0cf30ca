"""Tiny sizes of each cell for the CPU tests (the kernels' plain versions
run there): the cell's files are read as they are and these values laid
over them."""

from __future__ import annotations

import torch

from benchmark import registry, run
from benchmark.trace import Stages

CORPUS = {"n_segments": 4096, "feature_dim": 32, "big_round_threshold": 0}
WORLD = {"world": {"n_clusters": 4, "angle_max": 1.3, "member_sigma": 0.03}}
EXTRACT = {"frame_hw": [64, 88], "fps": 3, "frames_per_clip": 30, "num_ticks": 3,
           "splits": [1], "frame_resize": [96, 64], "crop_size": 64, "batch_clips": 1}
LOOPS = {"rounds": (CORPUS, dict(WORLD, groups=3, check_groups=2)),
         "query": (CORPUS, dict(WORLD, pool_batches=2, check_batches=2)),
         "extract": (EXTRACT, {"pool_batches": 1, "warm_batches": 1})}


def overrides(cell_name: str, root: str = registry.ROOT, bench_dir: str = registry.BENCH_DIR):
    spec = registry.load_spec(root)
    entry = registry.find_cell(spec, cell_name)
    loop = registry.load_traffic(entry["traffic"], bench_dir)["loop"]
    return LOOPS[loop]


def execute(cell_name: str, seconds: float = 0.5, trace: bool = False, seed: int = 2 ** 33 + 7,
            root: str = registry.ROOT, bench_dir: str = registry.BENCH_DIR) -> dict:
    torch.set_num_threads(2)
    config, traffic = overrides(cell_name, root, bench_dir)
    return run.execute(cell_name, seed, seconds, trace, "cpu", root=root,
                       config_override=config, traffic_override=traffic,
                       bench_dir=bench_dir, t_start=0.0)


def cell(cell_name: str, seed: int = 11, seconds: float = 0.5):
    """A tiny cell after its window, its program state released: (cell,
    limits, loop name)."""
    torch.set_num_threads(2)
    spec = registry.load_spec()
    entry = registry.find_cell(spec, cell_name)
    config = registry.load_config(spec, entry["config"])
    traffic = registry.load_traffic(entry["traffic"])
    small_config, small_traffic = LOOPS[traffic["loop"]]
    config.update(small_config)
    traffic.update(small_traffic)
    c = registry.load_loop(traffic).Cell(config, traffic, seed, torch.device("cpu"),
                                         Stages(False))
    c.warm()
    c.run(seconds)
    c.release()
    return c, traffic["limits"], traffic["loop"]
