"""A payload function for decode-worker tests that imports neither torch nor
jax: it yields, once, the names of those frameworks that the worker process
has loaded."""

import sys


def loaded_frameworks(path, cfg, flow_res_div, new_size):
    yield sorted(m for m in ("torch", "jax") if m in sys.modules)
