"""The table's IVF_PQ index rebuilt back to back, in place.

Each build is ``tbl.create_index(metric=..., replace=True, **index)`` with
the configuration's ``index`` group; the window ends with the first build
that finishes after ``--seconds``. The mix's parameters: ``warm_builds``
(made in set-up), ``check_sample_rows`` (the rows the check samples from
the seed) and ``check_search_batch`` (the queries of one refined search
after the window, which has to see the last build)."""

from __future__ import annotations

import io
import time

import numpy as np
import torch

from portbench import drive

INDEX_FILES = ("centroids", "row_ids", "codes", "codebooks")


def set_up(cfg: dict, traffic: dict, seed: int, device, connect) -> drive.Setup:
    if cfg["index"]["index_type"] != "IVF_PQ":
        raise ValueError("this loop judges IVF_PQ arrays; another index type needs its own loop")
    st = drive.open_table(cfg, seed, device, connect)
    t = time.monotonic()
    for _ in range(int(traffic["warm_builds"])):
        st.tbl.create_index(**drive.index_args(cfg))
    drive.sync(device)
    st.timed("warm_builds", t)
    return st


def index_files(tbl) -> dict:
    """The newest vector index's files as the port wrote them (bytes)."""
    ds = tbl._dataset
    meta = [ix for ix in ds.manifest.indices if ix.index_type.startswith("IVF")][-1]
    root = ds.index_dir(meta.uuid)
    return {"uuid": meta.uuid, **{n: ds.store.read_bytes(f"{root}/{n}.npy") for n in INDEX_FILES}}


def window(st: drive.Setup, cfg: dict, traffic: dict, seconds: float, seed: int, device,
           tracer=None) -> drive.Window:
    """Builds back to back until the first that finishes after ``seconds``;
    each build's files are kept for the check."""
    w = drive.Window()
    t_start = time.perf_counter()
    i = 0
    while True:
        if tracer is not None:
            tracer.call = i
        try:
            st.tbl.create_index(**drive.index_args(cfg))
            drive.sync(device)
            w.kept.append(index_files(st.tbl))
        except Exception as e:
            w.failed += 1
            w.errors.append(f"build {i}: {type(e).__name__}: {e}")
        t1 = time.perf_counter()
        i += 1
        if t1 - t_start >= seconds:
            break
    if tracer is not None:
        tracer.call = -1
    w.seconds = t1 - t_start
    w.attempted = i
    w.builds = i - w.failed
    return w


def answers(st: drive.Setup, w: drive.Window, cfg: dict, traffic: dict) -> dict:
    """Each build's files, and one refined search on the last build."""
    searches = []
    rows = np.arange(int(traffic["check_search_batch"])) % len(st.pool)
    try:
        out = drive.search_call(st.tbl, cfg, None, st.pool[rows])
        searches.append((rows, drive.answers(out, len(rows), int(cfg["search"]["k"]),
                                             int(cfg["dim"]))))
    except Exception as e:
        w.failed += 1
        w.errors.append(f"search after the builds: {type(e).__name__}: {e}")
    return {"pool": st.pool, "searches": searches, "indexes": w.kept}


def _sample(n: int, rows: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return torch.randperm(n, generator=g)[:rows].to(device)


def judge(found: dict, cfg: dict, traffic: dict, seed: int, device) -> list[dict]:
    """The search on the last build as a search's, and each build's arrays
    against the reference's own build of the same rows from the seed."""
    from portbench.reference import build as ref_build
    from portbench.reference import judge as ref_judge

    x = drive.redraw_rows(cfg, seed, device)
    checks = drive.judge_searches(found["searches"], x, found["pool"], cfg, None)
    if found["indexes"]:
        sample = _sample(x.shape[0], int(traffic["check_sample_rows"]), seed, device)
        x_s = x[sample]
        ref_err = ref_judge.reference_error(x_s, sample, ref_build.build_ivf_pq(x, cfg["index"],
                                                                                seed))
        for files in found["indexes"]:
            a = {n: np.load(io.BytesIO(files[n])) for n in INDEX_FILES}
            idx = ref_judge.canonical_index(a["centroids"], a["row_ids"], a["codes"],
                                            a["codebooks"], x.shape[0])
            checks.append(ref_judge.judge_build(x_s, sample, idx, ref_err, cfg))
    return checks


def control(cfg: dict, traffic: dict, seed: int, device, fault: str | None = None) -> list[dict]:
    """The reference's build in the port's place, in the configuration's
    ``control_build`` precision; with ``fault="kmeans_unchanged"``, in
    float32 with its centroids left at their k-means++ seeds instead."""
    from portbench.reference import build as ref_build
    from portbench.reference import judge as ref_judge

    x = drive.redraw_rows(cfg, seed, device)
    sample = _sample(x.shape[0], int(traffic["check_sample_rows"]), seed, device)
    x_s = x[sample]
    ref_err = ref_judge.reference_error(x_s, sample, ref_build.build_ivf_pq(x, cfg["index"], seed))
    if fault == "kmeans_unchanged":
        low = ref_build.build_ivf_pq(x, dict(cfg["index"], max_iterations=0), seed)
    elif fault is None:
        low = ref_build.build_ivf_pq(x, cfg["index"], seed, cfg["precision"]["control_build"])
    else:
        raise ValueError(f"no planted fault {fault!r} for a build")
    return [ref_judge.judge_build(x_s, sample, low, ref_err, cfg)]
