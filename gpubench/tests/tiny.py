"""A throwaway benchmark root at a size the CPU runs in seconds: a
shipped configuration cut to ngrid^3 rows a species in a box cut alike
(the same resolution), its traffic, limits and readers copied beside
it."""

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELL = "tiny-z9"


def make_root(tmp, ngrid=16, cell=CELL, traffic="zeldovich-z9",
              limits=None, config="dm50-512-share512",
              limits_of="dm50-share512-z9"):
    tmp = Path(tmp)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads(
        (REPO / "gpubench" / "configs" / f"{config}.json").read_text())
    scale = ngrid / cfg["Ngrid"]
    cfg.update(name="tiny", Ngrid=ngrid, Nmesh=2 * ngrid,
               BoxSize=cfg["BoxSize"] * scale)
    (tmp / "gpubench" / "configs").mkdir(parents=True)
    (tmp / "gpubench" / "limits").mkdir()
    (tmp / "gpubench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    for sub in ("traffic", "metrics"):
        shutil.copytree(REPO / "gpubench" / sub, tmp / "gpubench" / sub)
    lim = {} if limits_of is None else json.loads(
        (REPO / "gpubench" / "limits" / f"{limits_of}.json").read_text())
    lim.update(limits or {})
    (tmp / "gpubench" / "limits" / f"{cell}.json").write_text(
        json.dumps(lim))
    bench["configs"] = [dict(bench["configs"][0], name="tiny",
                             file="gpubench/configs/tiny.json")]
    bench["workloads"] = [{"name": cell, "config": "tiny",
                           "traffic": traffic, "chips": 1,
                           "why": "a CPU rehearsal"}]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
