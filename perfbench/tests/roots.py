"""A benchmark root at tiny sizes, for the benchmark's own tests.

``make_root`` copies ``BENCHMARK.json`` and the benchmark's data files
into a temporary directory, with each configuration cut to a few dozen
pixels and each cell given limits for the CPU's routes, whose outputs
are float32 where the card's are bf16.
"""

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# (src_shape, src_isocenter) of each configuration at test size
TINY = {"resize4k": ([54, 96], [0.0, 0.0]),
        "rot2048": ([64, 64], [32.0, 32.0])}
# the CPU routes' outputs (float32, bf16 for the shear route) read at
# most 3 ulps of their dtype; the control (bf16 arithmetic) 26 bf16 ulps
# (shear) and 1e5 float32 ulps and more; a fault thousands
CPU_LIMITS = {"excess_ulp": {"limit": 8.0},
              "max_ulp": {"limit": 8.0}}


def make_root(dst: Path, frames: int = 4) -> Path:
    dst = Path(dst)
    (dst / "perfbench").mkdir(parents=True)
    for d in ("metrics", "traffic"):
        shutil.copytree(REPO / "perfbench" / d, dst / "perfbench" / d)
    for d in ("configs", "cells"):
        (dst / "perfbench" / d).mkdir()
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg["src_shape"], cfg["src_isocenter"] = TINY[c["name"]]
        (dst / c["file"]).write_text(json.dumps(cfg))
    for f in (dst / "perfbench" / "traffic").glob("*.json"):
        tr = json.loads(f.read_text())
        tr.update(frames=frames)
        f.write_text(json.dumps(tr))
    for w in bench["workloads"]:
        name = f"{w['name']}.json"
        cell = json.loads((REPO / "perfbench" / "cells" / name).read_text())
        cell["limits"] = CPU_LIMITS
        (dst / "perfbench" / "cells" / name).write_text(json.dumps(cell))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst
