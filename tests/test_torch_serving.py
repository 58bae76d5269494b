"""The port's serving front end beside the JAX package's on the same inputs
(CPU): the copied `bucket_len`, `LaneTable`, `Scheduler` (EDF, affinity
inside a slack band and its per-epoch memo, `pop_expired`, `chunk_urgent`),
`AdmissionController`, `Telemetry` with its nearest-rank percentile, and
`poisson_requests`; the store's and the pipeline's `affinity_epoch`; then the
flag table: `SERVE_FLAGS`, the serve parser's flags, dests, defaults and
choices, `from_args` round trips, `from_kwargs`, and the validation messages,
equal to the reference's. `--tenants`, `--fault-plan` and `--ep-shards`
serve on the CPU; only shards on distinct devices are refused (ROADMAP
A14(c)). Everything compares exactly."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.offload import ExpertStore as JExpertStore
from repro.launch import serve as jserve
from repro.models.transformer import init_params as j_init_params
from repro.serving import config as jconfig
from repro.serving import request as jrequest
from repro.serving import scheduler as jsched
from repro.serving import telemetry as jtele
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.core.hash_table import HashTable
from repro_torch.core.offload import ExpertStore, PrefetchPipeline
from repro_torch.launch import serve
from repro_torch.serving import config as tconfig
from repro_torch.serving import request as trequest
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import telemetry as ttele

torch.set_num_threads(2)


def _pair(n_req=12, seed=0):
    """The same request stream as the reference's and the port's Requests,
    with hash tables (one layer, one expert id a token) on most of them."""
    out = []
    for mod in (jrequest, trequest):
        r2 = np.random.default_rng(seed)
        reqs = []
        for i in range(n_req):
            P = int(r2.integers(1, 30))
            slo = None if r2.random() < 0.3 else float(r2.uniform(-1.0, 3.0))
            r = mod.Request(rid=i, prompt=r2.integers(0, 50, (P,)).astype(np.int32),
                            max_new_tokens=int(r2.integers(1, 9)),
                            arrival_s=float(r2.uniform(0, 2)), slo_s=slo)
            if r2.random() < 0.85:
                e = int(r2.integers(0, 4))
                r.table = HashTable(i, np.full((1, 1, P, 1), e, np.int32),
                                    np.ones((1, 1, P, 1), np.float32))
            reqs.append(r)
        out.append(reqs)
    return out


class _Affinity:
    """A deterministic affinity provider that counts its scans."""

    def __init__(self):
        self.affinity_epoch = 0
        self.calls = 0

    def cache_affinity(self, table):
        self.calls += 1
        return float((int(table.expert_ids.flat[0]) * 7 + self.affinity_epoch) % 5) / 5


# ---------------------------------------------------------------------------
# scheduler pieces
# ---------------------------------------------------------------------------


def test_bucket_len_and_lane_table_match_jax():
    for buckets in ((8, 16), (8, 16, 32, 64, 128), (64, 128, 256)):
        for n in range(1, buckets[-1] + 1, 3):
            assert tsched.bucket_len(n, buckets) == jsched.bucket_len(n, buckets)
        for mod in (tsched, jsched):
            with pytest.raises(ValueError, match="exceeds largest bucket"):
                mod.bucket_len(buckets[-1] + 1, buckets)
    assert tsched.DEFAULT_BUCKETS == jsched.DEFAULT_BUCKETS == tconfig.DEFAULT_BUCKETS
    jr, tr = _pair(6)
    lj, lt = jsched.LaneTable(3), tsched.LaneTable(3)
    ops = [("a", 0), ("a", 1), ("r", 0), ("a", 2), ("a", 3), ("r", 2), ("r", 1), ("a", 4)]
    for op, i in ops:
        if op == "a":
            assert lt.assign(tr[i]) == lj.assign(jr[i]) and tr[i].lane == jr[i].lane
        else:
            lane = jr[i].lane
            assert lt.release(lane).rid == lj.release(lane).rid == i
        assert lt.active() == lj.active() and lt.free_count() == lj.free_count()
    with pytest.raises(IndexError):
        for i in range(5):
            lt.assign(tr[5])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_matches_jax(seed):
    """The same queue through both schedulers: each prefill batch (EDF, then
    affinity inside a slack band, the anchor's bucket), the expired drops,
    chunk urgency and the affinity memo's scan counts are equal."""
    jr, tr = _pair(14, seed)
    sj, st = jsched.Scheduler(buckets=(8, 16, 32)), tsched.Scheduler(buckets=(8, 16, 32))
    aj, at = _Affinity(), _Affinity()
    for r in jr:
        sj.enqueue(r)
    for r in tr:
        st.enqueue(r)
    for r_j, r_t in zip(jr, tr):
        for now, chunks, chunk_s in ((0.0, 3, 0.2), (1.5, 1, 0.0), (0.5, 8, 0.5)):
            assert st.chunk_urgent(r_t, now, chunks, chunk_s) == \
                sj.chunk_urgent(r_j, now, chunks, chunk_s)
    now = 0.0
    for step in range(8):
        if step == 3:
            assert [r.rid for r in st.pop_expired(now)] == [r.rid for r in sj.pop_expired(now)]
        if step == 5:
            aj.affinity_epoch = at.affinity_epoch = 1     # residency moved
        bj, kj = sj.next_prefill_batch(now, 3, aj)
        bt, kt = st.next_prefill_batch(now, 3, at)
        assert ([r.rid for r in bt], kt) == ([r.rid for r in bj], kj)
        assert [r.state.value for r in bt] == [r.state.value for r in bj]
        assert st.pending() == sj.pending() and at.calls == aj.calls
        now += 0.4
    assert [r.state.value for r in tr] == [r.state.value for r in jr]


def test_affinity_epoch_moves_with_residency():
    """The store's epoch moves exactly when residency changes, as the
    reference's; the pipeline's adds its upload count."""
    cfg_j = dataclasses.replace(jget_config("switch-base-8").reduced(), n_layers=2)
    import jax

    pj = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), cfg_j))
    cfg_t = dataclasses.replace(get_config("switch-base-8").reduced(), n_layers=2)
    sj = JExpertStore(cfg_j, pj, slots_per_layer=2)
    st = ExpertStore(cfg_t, params_from_numpy(pj), slots_per_layer=2, device="cpu")
    L = st.L
    for e in (0, 0, 1, 2, 1, 3):        # fifo over 2 slots: hits, loads, evictions
        tbl = HashTable(0, np.full((L, 1, 2, 1), e, np.int32), np.ones((L, 1, 2, 1), np.float32))
        sj.prepare(tbl)
        st.prepare(tbl)
        assert st.affinity_epoch == sj.affinity_epoch
        assert st.cache_affinity(tbl) == sj.cache_affinity(tbl) == 1.0
    # unchanged residency (a repeated table, a hit) leaves the epoch alone
    e0 = st.affinity_epoch
    st.prepare(tbl)
    assert st.affinity_epoch == e0
    pf = PrefetchPipeline(st, depth=2)
    try:
        assert pf.affinity_epoch == (e0, 0)
        tk = pf.submit(HashTable(0, np.full((L, 1, 2, 1), 0, np.int32),
                                 np.ones((L, 1, 2, 1), np.float32)))
        tk.wait()
        tk.release()
        assert pf.affinity_epoch[0] > e0 and pf.affinity_epoch[1] == pf.stats.uploads > 0
        assert pf.degraded_fraction() == 0.0
    finally:
        pf.close()


def test_admission_controller_matches_jax():
    cj, ct = jsched.AdmissionController(margin=0.8), tsched.AdmissionController(margin=0.8)
    rng = np.random.default_rng(3)
    for _ in range(60):
        if rng.random() < 0.4:
            s = float(rng.uniform(0.05, 2.0))
            cj.observe(s)
            ct.observe(s)
        depth = int(rng.integers(0, 20))
        slack = None if rng.random() < 0.1 else float(rng.uniform(-0.5, 6.0))
        deg = float(rng.choice([0.0, 0.5]))
        assert ct.should_shed(depth, slack, deg) == cj.should_shed(depth, slack, deg)
        assert ct.est_wait_s(depth) == cj.est_wait_s(depth) and ct.shedding == cj.shedding
    assert vars(ct.clone()) == vars(cj.clone())


def test_telemetry_and_poisson_requests_match_jax():
    rng = np.random.default_rng(4)
    tj, tt = jtele.Telemetry(), ttele.Telemetry()
    for _ in range(40):
        v = float(rng.exponential())
        for t in (tj, tt):
            t.counter("c").inc(v)
            t.gauge("g").set(v)
            t.histogram("h").observe(v)
    for q in (0, 1, 33, 50, 95, 99, 100):
        assert tt.histogram("h").percentile(q) == tj.histogram("h").percentile(q)
    h = ttele.Histogram()
    for v in [1.0, 2.0, 3.0, 4.0]:
        h.observe(v)
    assert (h.percentile(50), h.percentile(33)) == (3.0, 2.0)       # nearest rank errs high
    sj, st = tj.snapshot(), tt.snapshot()
    sj.pop("wall_s"), st.pop("wall_s")
    assert st == sj
    assert tt.ratio("c", "missing") == 0.0
    for kw in (dict(), dict(prompt_len_range=(16, 256), max_new_range=(8, 64), slo_s=5.0)):
        rj = jrequest.poisson_requests(np.random.default_rng(0), 24, 8.0, 32128, **kw)
        rt = trequest.poisson_requests(np.random.default_rng(0), 24, 8.0, 32128, **kw)
        for a, b in zip(rj, rt):
            assert (a.rid, a.arrival_s, a.max_new_tokens, a.slo_s, a.deadline_s) == \
                (b.rid, b.arrival_s, b.max_new_tokens, b.slo_s, b.deadline_s)
            np.testing.assert_array_equal(a.prompt, b.prompt)
    assert [s.value for s in trequest.RequestState] == [s.value for s in jrequest.RequestState]


# ---------------------------------------------------------------------------
# the flag table and the config
# ---------------------------------------------------------------------------


def test_serve_flags_equal_the_reference():
    assert [(s.flag, s.path, s.kwargs, s.dest) for s in tconfig.SERVE_FLAGS] == \
        [(s.flag, s.path, s.kwargs, s.dest) for s in jconfig.SERVE_FLAGS]
    assert tconfig.KWARG_PATHS == jconfig.KWARG_PATHS

    def actions(parser, skip=()):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs,
                         a.const, a.help)
                for a in parser._actions if a.dest not in skip}

    # the port's parser is the reference's, plus --device
    got = actions(serve.build_parser(), skip=("device",))
    assert got == actions(jserve.build_parser())
    assert serve.build_parser().parse_args([]).device is None


FLAG_MATRIX = [
    [], ["--slots", "3"], ["--eviction", "lru"], ["--prefetch-depth", "2"],
    ["--staging-buffers", "3"], ["--host-quant", "int8"], ["--quantized-slots"],
    ["--scale-granularity", "tensor"], ["--spec-mode", "draft", "--spec-k", "2"],
    ["--lanes", "2", "--prefill-batch", "2"], ["--drop-expired"], ["--wfq-quantum", "32"],
    ["--ep-shards", "2", "--rebalance-interval", "1.5"],
    ["--kv-pages", "16", "--page-size", "8", "--prefill-chunk", "16", "--quantized-slots",
     "--int4-slots", "--tier-split", "0.5", "--fence-timeout", "0.5"],
    ["--kv-pages", "64", "--page-size", "16", "--prefill-chunk", "256", "--max-seq", "2048",
     "--seq", "1536", "--new-tokens", "64"],
    ["--fault-plan", "upload:fail@1;thread:crash@2", "--fault-seed", "3"],
    ["--tenants", "paid:weight=4:pin=0.5,free:rate=200:burst=50"],
    ["--shed-margin", "0.5", "--slo", "2.0"], ["--seq", "256"],
]


def _plain(obj):
    """A config as plain data: dataclasses as dicts (either package's), the
    fault plan by its specs, the shed gate by its settings."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [_plain(x) for x in obj]
    if hasattr(obj, "specs") and hasattr(obj, "seed"):        # FaultPlan
        return {"specs": _plain(list(obj.specs)), "seed": obj.seed}
    if type(obj).__name__ == "AdmissionController":
        return dict(vars(obj))
    return obj


@pytest.mark.parametrize("flags", FLAG_MATRIX, ids=lambda f: " ".join(f) or "defaults")
def test_from_args_round_trips_like_the_reference(flags):
    argv = ["--engine", "server", *flags]
    got = serve.validate_serve_args(serve.build_parser().parse_args(argv))
    want = jserve.validate_serve_args(jserve.build_parser().parse_args(argv))
    assert _plain(got) == _plain(want)
    for spec in tconfig.SERVE_FLAGS:
        if spec.path is not None:
            assert tconfig.resolve_path(got, spec.path) == jconfig.resolve_path(want, spec.path)


BAD_FLAGS = [
    "--int4-slots",
    "--int4-slots --quantized-slots --replicate-hot 1 --ep-shards 4",
    "--int4-slots --quantized-slots --tier-split 0.0",
    "--int4-slots --quantized-slots --tier-split 1.5",
    "--int4-slots --quantized-slots --quant-group 0",
    "--prefill-chunk 8",
    "--max-seq 64",
    "--kv-pages 8 --engine sida",
    "--kv-pages 8 --max-seq 64",
    "--kv-pages 2 --seq 64",
    "--kv-pages 8 --seq 128 --new-tokens 64",
    "--kv-pages 8 --spec-mode draft --spec-k 200",
    "--replicate-hot 1",
    "--rebalance-interval 0.5",
    "--replicate-hot -1 --ep-shards 4",
    "--rebalance-interval 0.5 --ep-shards 4 --engine sida",
    "--shed-margin 0.5",
    "--tenants a:weight=0",
    "--tenants a:pin=0",
    "--tenants a,a",
    "--wfq-quantum 0",
    "--fault-plan bogus:fail",
    "--fence-timeout -1",
]


@pytest.mark.parametrize("flags", BAD_FLAGS)
def test_invalid_flags_give_the_reference_message(flags):
    argv = ["--engine", "server", *flags.split()]
    with pytest.raises(SystemExit) as got:
        serve.validate_serve_args(serve.build_parser().parse_args(argv))
    with pytest.raises(SystemExit) as want:
        jserve.validate_serve_args(jserve.build_parser().parse_args(argv))
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("serve: invalid flags")


def test_config_errors_and_kwargs_match_the_reference():
    for bad in ["a:weight=0", "a:pin=1.5", "a,a", "a:bogus=1", "a:weight=x", ":weight=1",
                "a:weight"]:
        with pytest.raises(tconfig.ServingConfigError) as got:
            tconfig.parse_tenants(bad)
        with pytest.raises(jconfig.ServingConfigError) as want:
            jconfig.parse_tenants(bad)
        assert str(got.value) == str(want.value)
    assert _plain(tconfig.parse_tenants("solo,paid:weight=4:slo=2")) == \
        _plain(jconfig.parse_tenants("solo,paid:weight=4:slo=2"))
    kw = dict(slots_per_layer=5, max_lanes=3, buckets=[16, 8], prefetch_depth=2,
              quantized_slots=True, drop_expired=True, spec_mode="draft", spec_k=3,
              cache_len=64, keep_decode_logits=True, fence_timeout_s=0.5)
    assert _plain(tconfig.ServingConfig.from_kwargs(**kw)) == \
        _plain(jconfig.ServingConfig.from_kwargs(**kw))
    with pytest.raises(TypeError, match="unexpected keyword"):
        tconfig.ServingConfig.from_kwargs(slotz_per_layer=2)
    for bad in (dict(slots_per_layer=0), dict(buckets=(16, 8)),
                dict(paged=tconfig.PagedKVConfig(page_size=8, kv_pages=1))):
        cfg_t = tconfig.ServingConfig.from_kwargs(**bad)
        cfg_j = jconfig.ServingConfig.from_kwargs(**{
            k: (jconfig.PagedKVConfig(**dataclasses.asdict(v)) if k == "paged" else v)
            for k, v in bad.items()})
        if bad.get("buckets"):      # from_kwargs sorts a ladder, as the reference does
            cfg_t.batching.buckets = cfg_j.batching.buckets = (16, 8)
        with pytest.raises(tconfig.ServingConfigError) as got:
            cfg_t.validate()
        with pytest.raises(jconfig.ServingConfigError) as want:
            cfg_j.validate()
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flags,item", [(["--ep-shards", "2"], "ep_shards=2"),
                                        (["--engine", "sida", "--ep-shards", "2"],
                                         "replica_loads=")])
def test_unported_flags_parse_and_are_refused(flags, item, capsys):
    """`--ep-shards` (ROADMAP A14, ported) parses, validates and serves on
    the CPU, through the request server and the batch engine; what is still
    refused is shards on distinct devices (A14(c))."""
    from repro_torch.launch.mesh import make_ep_mesh

    argv = ["--device", "cpu", "--requests", "1", "--no-realtime", "--seq", "8", *flags]
    if "--engine" not in flags:
        argv = ["--engine", "server", *argv]
    serve.validate_serve_args(serve.build_parser().parse_args(argv))     # parses and validates
    serve.main(argv)
    assert item in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match=r"A14\(c\)"):
        make_ep_mesh(2, devices=["cpu", "meta"])


@pytest.mark.parametrize("flags", [["--tenants", "paid:weight=4:pin=0.5,free"],
                                   ["--fault-plan", "upload:fail,p=0.3", "--prefetch-depth", "2"]],
                         ids=["tenants", "fault-plan"])
def test_tenant_and_fault_flags_serve_on_the_cpu(flags, capsys):
    """`--tenants` (one Poisson stream a tenant) and `--fault-plan` serve
    through `--engine server` on the CPU: every request completes, with the
    tenants' summary blocks or the fault plan's counters."""
    argv = ["--engine", "server", "--device", "cpu", "--requests", "2", "--rate", "8",
            "--lanes", "2", "--new-tokens", "3", "--seq", "12", "--no-realtime", *flags]
    serve.main(argv)
    out = capsys.readouterr().out
    n = 4 if "--tenants" in flags else 2
    assert f"  completed            {n:.4f}" in out
    assert f"  rejected             {0:.4f}" in out
    if "--tenants" in flags:
        assert "  tenant paid:" in out and "  tenant free:" in out
    else:
        assert '"fault_ops_upload"' in out and "  upload_retries" in out


def test_server_cli_runs_on_the_cpu_and_refuses_without_a_gpu(capsys, monkeypatch):
    base = ["--engine", "server", "--device", "cpu", "--requests", "4", "--rate", "8",
            "--lanes", "2", "--new-tokens", "3", "--seq", "16", "--no-realtime"]
    keys = ("completed", "throughput_tok_s", "p95_latency_s", "cache_hit_rate", "h2d_mb",
            "spec_acceptance_rate", "paged_kv", "degraded_shards")
    for extra, paged in (([], False), (["--kv-pages", "16", "--page-size", "8",
                                        "--prefill-chunk", "8"], True),
                         (["--spec-mode", "draft", "--spec-k", "3"], False)):
        serve.main(base + extra)
        out = capsys.readouterr().out
        assert out.startswith("engine=server slots=2 lanes=2")
        for key in keys:
            assert f"  {key}" in out, key
        assert ("kv_pages_allocated" in out) == paged
        assert "  completed            4.0000" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main([a for a in base if a not in ("--device", "cpu")])
