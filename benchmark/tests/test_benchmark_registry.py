"""The harness finds a configuration, a traffic mix, a metric and a cell
that a later change adds as new files and entries, with no edit to a
file that is there."""

import json
import os

from conftest import BENCH_DIR


def test_committed_cells_resolve():
    from harness.registry import Registry

    reg = Registry()
    for w in reg.bench["workloads"]:
        cfg = reg.config(w["config"])
        tr = reg.traffic(w["traffic"])
        assert cfg["name"] == w["config"]
        assert reg.driver(tr["driver"]).Driver
        assert set(reg.limits(w["name"])) == {
            "loss_gap", "grad1_gap", "change3_gap", "segment_diff"}
        for m in reg.metrics(w["name"], False) + reg.metrics(w["name"],
                                                             True):
            assert callable(reg.reader(m["name"]))


def test_files_added_alone_make_a_new_cell(tiny):
    root, b = tiny.root, tiny.bench_dir
    # a configuration: its file of sizes
    with open(os.path.join(b, "configs", "tiny-lr.json")) as f:
        cfg = json.load(f)
    cfg.update(name="wide-lr", n_features=40)
    with open(os.path.join(b, "configs", "wide-lr.json"), "w") as f:
        json.dump(cfg, f)
    # a traffic mix: data for an existing driver
    with open(os.path.join(b, "traffic", "ma4.json")) as f:
        mix = json.load(f)
    mix.update(replicas=2, local_steps=3)
    with open(os.path.join(b, "traffic", "ma2.json"), "w") as f:
        json.dump(mix, f)
    # a per-layer metric: a reader of its own
    with open(os.path.join(b, "metrics", "rounds_per_s.py"), "w") as f:
        f.write("def read(ctx):\n"
                "    w = ctx['window']\n"
                "    return w['rounds'] / w['seconds'] if w['rounds'] "
                "else None\n")
    with open(os.path.join(b, "limits", "wide-lr.ma2.json"), "w") as f:
        json.dump({"loss_gap": 1.0, "grad1_gap": 1.0, "change3_gap": 1.0,
                   "segment_diff": 1.0}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="wide-lr",
                                 file="benchmark/configs/wide-lr.json"))
    bench["workloads"].append(dict(name="wide-lr.ma2", config="wide-lr",
                                   traffic="ma2", chips=1, why="new"))
    bench["per_layer"].append(dict(
        name="rounds_per_s", unit="rounds/s", better="higher",
        source="host_clock", layer="local-update trainer",
        moves="train_rows_per_s", workloads=["wide-lr.ma2"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    import time

    from harness.cell import run_cell
    from harness.registry import Registry

    res = run_cell(Registry(root, b), "wide-lr.ma2", seed=5,
                   seconds=0.3, trace=True, device="cpu",
                   t_start=time.perf_counter())
    assert res["metrics"]["rounds_per_s"]["unit"] == "rounds/s"
    assert res["metrics"]["rounds_per_s"]["value"] > 0
    # the committed folder holds none of it
    assert not os.path.exists(os.path.join(BENCH_DIR, "traffic",
                                           "ma2.json"))
