"""The entry ``aainterp_torch.api.area_average_interpolate``, called as a
user calls it.

A traffic file names it with ``"entry": "area_average_interpolate"``.
Its ``mode`` and ``call`` (further keyword arguments) go to the call;
with ``prebuilt_operator`` the operator is built once through
``api.build_operator`` and passed as ``operator=``.  The configuration
gives the geometry.

An entry module has four functions: ``private_caches`` (a context in
which the program's own data caches lie in the run's scratch
directory), ``build`` (the program's libraries, on the card), ``make``
(the call, and the seconds of geometry it took outside the call) and
``counters`` (the program's counters; those named ``launch.*`` count
kernel launches).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, Tuple

_CACHE_ENV = "AAINTERP_CACHE_DIR"
_CACHE_MODULE = "aainterp_torch.utils.cache"


@contextlib.contextmanager
def private_caches(scratch: Path) -> Iterator[None]:
    """The program's disk cache of plans in ``scratch``, which lives for
    one run: every run builds its plans, as a new process with a new
    geometry does, and reads nothing another run wrote.  The program
    reads the directory from its environment when it is imported; where
    it was imported before, its module's default is set the same."""
    path = str(Path(scratch) / "plans")
    old_env = os.environ.get(_CACHE_ENV)
    mod = sys.modules.get(_CACHE_MODULE)
    old_dir = getattr(mod, "DEFAULT_CACHE_DIR", None)
    os.environ[_CACHE_ENV] = path
    if mod is not None:
        mod.DEFAULT_CACHE_DIR = path
    try:
        yield
    finally:
        if old_env is None:
            os.environ.pop(_CACHE_ENV, None)
        else:
            os.environ[_CACHE_ENV] = old_env
        mod = sys.modules.get(_CACHE_MODULE)
        if mod is not None:
            # what the program reads without this run
            mod.DEFAULT_CACHE_DIR = old_dir or old_env or os.path.expanduser(
                "~/.cache/aainterp")


def build() -> None:
    """Build (a checkout's first run) or load the production libraries,
    in the program's build directory inside the checkout."""
    from aainterp_torch import _build
    _build.build_many((_build.SEPARABLE, _build.SEPARABLE_2D,
                       _build.ELL_SHEAR, _build.SHEAR3_STAGE, _build.NATIVE))


def make(cfg: dict, traffic: dict) -> Tuple[Callable, Dict[str, float]]:
    """The cell's call, and ``{'build_operator_s'}``: the seconds of
    ``api.build_operator`` where the operator is prebuilt, else 0."""
    from aainterp_torch import api
    from aainterp_torch.grids import make_grid_spec

    args = (float(cfg["src_resolution"]), float(cfg["dst_resolution"]),
            tuple(float(v) for v in cfg["src_isocenter"]),
            float(cfg["rotation_angle"]))
    kwargs = dict(traffic.get("call", {}), mode=traffic["mode"])
    parts = {"build_operator_s": 0.0}
    if traffic.get("prebuilt_operator"):
        t0 = time.perf_counter()
        gspec = make_grid_spec(tuple(cfg["src_shape"]), *args)
        kwargs["operator"] = api.build_operator(gspec, mode=traffic["mode"])
        parts["build_operator_s"] = time.perf_counter() - t0

    def call(x):
        # looked up at each call, as a user's code does
        return api.area_average_interpolate(x, *args, **kwargs).dst

    return call, parts


def counters() -> Dict[str, int]:
    """The wrappers' launch counters (``launch.*``), the route's plan
    fallbacks and the plan cache's builds and loads, flattened."""
    from aainterp_torch import api
    from aainterp_torch.ops import cuda_apply, cuda_apply_2d
    from aainterp_torch.ops import cuda_shear, cuda_shear3
    out = {"launch.cuda_apply": cuda_apply.LAUNCHES,
           "launch.cuda_apply_2d": cuda_apply_2d.LAUNCHES,
           "shear_plan_fallbacks": api.SHEAR_PLAN_FALLBACKS}
    out.update({f"launch.cuda_shear.{k}": v
                for k, v in cuda_shear.LAUNCHES.items()})
    out.update({f"launch.cuda_shear3.{k}": v
                for k, v in cuda_shear3.LAUNCHES.items()})
    out.update({f"plan_disk.{k}": v for k, v in cuda_shear.PLAN_DISK.items()})
    return out
