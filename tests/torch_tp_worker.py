"""Worker program of the port's tensor-parallel serving tests (started by
``sparkdl_tpu_torch.runner.launcher.launch``; it holds no test).

Every rank joins the gloo gang through ``XlaRunner(device="cpu")`` from
the launcher's ``SPARKDL_*`` env, runs every case of its mode and writes
what it computed to ``<out_dir>/rank<r>.pt`` (a dict of tensors, lists
and strings); the parent test holds that against the JAX package. It
imports only torch and the port. The flax parameters
(``tiny.pt``, ``tp4.pt``) and the prompts and reference streams the cases
need (``cases.pt``) come from the parent in ``in_dir``.

Usage: ``torch_tp_worker.py <mode> <in_dir> <out_dir>``, ``mode``:

- ``tp2`` (2 ranks): ``tp_mesh`` and its refusals, ``from_model``'s mesh
  inference and disagreement, the lean tp = 2 composition (paging, radix
  graft, chunked prefill, speculation, preempt-resume, bytes, signatures,
  gauges), the sharded decode kernels' dispatch, int8 KV + int8 weights
  across tp 1/2 and paged kernel off/forced (and every rank's int8 codes
  and scales), the per-device ``kv_pool_mb`` budget, odd MLP and
  vocabulary widths left whole, the decode
  resolvers' mesh gating, ``head_sharded_kernel`` over ``DTensor``
  inputs, the rank-0 clock; the started engine's front
  (``serving.group``): threaded clients on rank 0 alone, a cancel and a
  deadline, drain and resume, a planned failover, an ``EngineFleet``
  replica drained mid-stream;
- ``matrix`` (4 ranks): ``tp_mesh``'s groups, tp 1/2/4 × paged +
  speculation / unpaged on the ``num_kv_heads=4`` model;
- ``fleet`` (4 ranks): two tp = 2 groups (ranks 0-1 and 2-3), each
  serving the parent's ``EngineFleet`` from its rank 0
  (``serving.remote.FrontServer``) round after round (``serve_rounds``);
- ``card_fleet`` (1 rank, on the card): the same for one one-rank group
  of an f32 model made from a seed (``cases.pt`` holds no flax tree).
"""

import os
import sys
import threading
import time as _time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def refusal(fn, exc=ValueError) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


def model_of(L, flax, cfg):
    return L.load_flax_params(L.LlamaModel(cfg, attn_fn=None, device="cpu"),
                              flax)


def serve(eng, prompts, new):
    hs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    eng.run_until_idle()
    return [h.result(1) for h in hs]


def mesh_cases(out):
    from sparkdl_tpu_torch.serving.backend import tp_mesh
    out["mesh2_ranks"] = tp_mesh(2).mesh.tolist()
    out["mesh1_ranks"] = tp_mesh(1).mesh.tolist()
    # the JAX package's offset knob, set where it would start no group
    # of this gang: read nowhere, the rank alone places it
    os.environ["SPARKDL_TP_DEVICE_OFFSET"] = "6"
    out["mesh_stale_offset"] = tp_mesh(2).mesh.tolist()
    del os.environ["SPARKDL_TP_DEVICE_OFFSET"]
    out["mesh_tp0"] = refusal(lambda: tp_mesh(0))
    out["mesh_tp3"] = refusal(lambda: tp_mesh(3))


def from_model_cases(out, L, flax, GenerationEngine):
    from sparkdl_tpu_torch.serving.backend import tp_mesh
    cfg = L.LlamaConfig.tiny()
    model = model_of(L, flax, cfg)
    mesh = tp_mesh(2)
    eng = GenerationEngine.from_model(model, num_slots=2, max_len=32,
                                      mesh=mesh, device="cpu")
    out["inferred"] = [type(eng.backend).__name__, eng.tp_degree]
    for tp in (4, 1):
        out[f"disagree_tp{tp}"] = refusal(lambda: GenerationEngine.from_model(
            model, num_slots=2, max_len=32, tp=tp, mesh=mesh, device="cpu"))


def lean_case(out, L, flax, cases, GenerationEngine):
    from sparkdl_tpu_torch.core.runtime import GLOBAL_COMPILE_CACHE
    from sparkdl_tpu_torch.runner import telemetry
    from sparkdl_tpu_torch.serving.draft import HistoryDraft

    c = cases["lean"]
    pa, pb, refs, new = c["pa"], c["pb"], c["refs"], c["new"]
    model = model_of(L, flax, L.LlamaConfig.tiny())
    prov = HistoryDraft()
    prov.observe(pa, refs[0])
    prov.observe(pb, refs[1])
    kw = dict(num_slots=2, max_len=64, prefill_chunk=8, block_size=8,
              prefill_budget=16, spec_k=3, draft_provider=prov,
              device="cpu")
    base_d = GLOBAL_COMPILE_CACHE.signatures("serve_decode_step")
    base_v = GLOBAL_COMPILE_CACHE.signatures("serve_verify_step")
    telemetry.reset()
    telemetry.start()
    try:
        eng = GenerationEngine.from_model(model, tp=2, **kw)
        out["lean_type"] = type(eng.backend).__name__
        out["lean_paged_tp"] = [eng.paged, eng.tp_degree]
        ha = eng.submit(pa, max_new_tokens=new)
        eng.step()
        eng.step()
        eng.step()
        sig_v = GLOBAL_COMPILE_CACHE.signatures("serve_verify_step")
        out["lean_mid"] = [eng.stats["spec_verifies"], ha.state,
                           len(ha.tokens)]
        eng._preempt_newest([(ha.slot, ha)])
        hb = eng.submit(pb, max_new_tokens=new)
        eng.run_until_idle()
        out["lean_streams"] = [ha.result(1), hb.result(1)]
        snap = eng.snapshot()
        out["lean_snap"] = [snap["preemptions"], snap["spec_verifies"],
                            (snap.get("prefix_cache") or {}).get("hits", 0),
                            snap["tp_degree"], snap["kv_pool_device_bytes"]]
        out["lean_sig"] = [
            GLOBAL_COMPILE_CACHE.signatures("serve_decode_step") - base_d,
            GLOBAL_COMPILE_CACHE.signatures("serve_verify_step") - base_v,
            GLOBAL_COMPILE_CACHE.signatures("serve_verify_step") - sig_v]
        out["lean_bytes"] = eng.kv_pool_device_bytes
        reg = telemetry.registry()
        out["lean_gauges"] = [
            reg.gauge("serving_tp_degree").snapshot()["max"],
            reg.gauge("serving_kv_pool_device_bytes").snapshot()["value"]]
        dbg = eng.debug_state()
        out["lean_debug"] = [dbg["tp_degree"], dbg["kv_pool_device_bytes"]]
    finally:
        telemetry.reset()
    one = GenerationEngine.from_model(model, tp=1, **kw)
    out["lean_bytes_tp1"] = one.kv_pool_device_bytes


def kernel_case(out, L, flax, cases, GenerationEngine):
    from sparkdl_tpu_torch.parallel import dispatch_counter
    c = cases["kernel"]
    model = model_of(L, flax, L.LlamaConfig.tiny())
    levers = ("SPARKDL_FLASH_DECODE", "SPARKDL_SERVE_PAGED_KERNEL")
    for arm, value in (("", None), ("_off", "0")):
        for lever in levers:
            if value is None:
                os.environ.pop(lever, None)
            else:
                os.environ[lever] = value
        for name, kw, fn in (
                ("paged", dict(max_len=48, block_size=8),
                 "paged_flash_decode"),
                ("dense", dict(max_len=128), "flash_decode")):
            counter = dispatch_counter(fn)
            counter.launches = 0
            eng = GenerationEngine.from_model(
                model, num_slots=3, prefill_chunk=8, tp=2, device="cpu",
                **kw)
            out[f"kernel_{name}{arm}"] = serve(eng, c["prompts"], c["new"])
            out[f"kernel_{name}{arm}_dispatch"] = [counter.launches,
                                                   eng.stats["steps"]]
    for lever in levers:
        os.environ.pop(lever, None)


def int8_case(out, L, flax, cases, GenerationEngine):
    from sparkdl_tpu_torch.serving.backend import tp_mesh
    c = cases["int8"]
    model = L.LlamaModel(L.LlamaConfig.tiny(), attn_fn=None, device="cpu")
    for tp, kernel in ((1, "0"), (1, "1"), (2, "0"), (2, "1")):
        os.environ["SPARKDL_SERVE_PAGED_KERNEL"] = kernel
        eng = GenerationEngine.from_model(
            model, flax, num_slots=3, max_len=48, block_size=8,
            prefill_chunk=8, kv_dtype="int8", weight_dtype="int8", tp=tp,
            device="cpu")
        out[f"int8_tp{tp}_k{kernel}"] = serve(eng, c["prompts"], c["new"])
        out[f"int8_tp{tp}_bytes"] = eng.kv_pool_device_bytes
    del os.environ["SPARKDL_SERVE_PAGED_KERNEL"]
    cache = eng.backend.cache
    out["int8_plane_bytes"] = sum(t.numel() * t.element_size()
                                  for t in cache.kv_scale)
    out["int8_code_bytes"] = sum(t.numel() * t.element_size()
                                 for t in cache.k + cache.v)
    out["int8_plane_shape"] = list(cache.kv_scale[0].shape)
    ps = eng.backend.pool_stats()
    out["int8_pool_stats"] = [ps["kv_dtype"], ps["kv_scale_bytes_per_block"]]
    # every rank's codes and scales: the global model quantized, then
    # sharded by the rules
    glob = L.quantize_params(model_of(L, flax, L.LlamaConfig.tiny()))
    local = L.shard_model(glob, tp_mesh(2))
    for name, t in local.state_dict().items():
        if "base" in name:
            out["int8_local/" + name] = t.clone()


def budget_case(out, L, flax4, GenerationEngine):
    cfg = L.LlamaConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=4, num_kv_heads=4, intermediate_size=256,
                        rope_theta=10000.0)
    model = model_of(L, flax4, cfg)
    got = {}
    for tp in (1, 2):
        eng = GenerationEngine.from_model(
            model, num_slots=2, max_len=32, block_size=8, kv_pool_mb=0.25,
            tp=tp, device="cpu")
        got[tp] = [eng.backend.pool_blocks, eng.kv_pool_device_bytes]
    out["budget"] = got


def odd_case(out, L, flax_odd, cases, GenerationEngine):
    """Odd MLP and vocabulary widths: the rules leave those dims whole,
    so nothing of them is reduced or gathered."""
    c = cases["odd"]
    model = model_of(L, flax_odd, L.LlamaConfig(**c["cfg"]))
    eng = GenerationEngine.from_model(model, num_slots=2, max_len=64,
                                      prefill_chunk=8, tp=2, device="cpu")
    out["odd_streams"] = serve(eng, c["prompts"], c["new"])
    m = eng.backend.model
    out["odd_widths"] = [
        m.heads, m.kv_heads, m.embed_tokens.weight.shape[1],
        m.layers[0].mlp.gate_proj.base.weight.shape[0],
        m.lm_head.weight.shape[0]]
    out["odd_groups"] = [m.layers[0].mlp.group is None,
                         m.head_group is None, m.embed_group is None]


def gating_case(out):
    """The resolvers under a mesh: the decode and paged levers, and
    nothing else, decide; what they return wraps the kernel."""
    from sparkdl_tpu_torch.ops import flash_decode as fd
    from sparkdl_tpu_torch.ops import paged_flash_decode as pfd
    from sparkdl_tpu_torch.serving.backend import tp_mesh
    mesh = tp_mesh(2)
    env = os.environ
    g = {}

    def wraps(fn, kernel):
        return fn is not None and fn.__wrapped__ is kernel

    fn = pfd.paged_decode_fn_for(None, mesh)
    g["paged_auto_wraps"] = wraps(fn, pfd.paged_flash_decode)
    g["paged_auto_name"] = fn.__name__
    env[pfd.PAGED_KERNEL_ENV] = "0"
    g["paged_off"] = pfd.paged_decode_fn_for(None, mesh) is None
    env["SPARKDL_FLASH_DECODE"] = "0"
    env[pfd.PAGED_KERNEL_ENV] = "1"
    g["paged_force_beats_dense_lever"] = wraps(
        pfd.paged_decode_fn_for(None, mesh), pfd.paged_flash_decode)
    del env[pfd.PAGED_KERNEL_ENV]
    g["paged_auto_follows_dense_lever"] = \
        pfd.paged_decode_fn_for(None, mesh) is None
    g["dense_lever_wins"] = fd.decode_fn_for(None, mesh) is None
    del env["SPARKDL_FLASH_DECODE"]
    fn = fd.decode_fn_for(None, mesh)
    g["dense_auto_wraps"] = wraps(fn, fd.flash_decode)
    g["dense_auto_name"] = fn.__name__
    out["gating"] = g


def head_sharded_case(out, cases):
    from torch.distributed.tensor import Shard, distribute_tensor

    from sparkdl_tpu_torch.ops import flash_decode as fd
    from sparkdl_tpu_torch.ops import paged_flash_decode as pfd
    from sparkdl_tpu_torch.parallel import head_sharded_kernel
    from sparkdl_tpu_torch.serving.backend import tp_mesh

    mesh = tp_mesh(2)
    c = {k: torch.as_tensor(v) for k, v in cases["pool"].items()}

    def dt(x):
        return distribute_tensor(x, mesh, [Shard(1)])

    sharded = head_sharded_kernel(pfd.paged_flash_decode, mesh)
    args = (c["tables"], c["cur"], c["pads"])
    got = sharded(dt(c["q"]), dt(c["k"]), dt(c["v"]), *args)
    want = pfd.paged_flash_decode(c["q"], c["k"], c["v"], *args)
    out["hs_paged_placements"] = str(tuple(got.placements))
    out["hs_paged"] = got.full_tensor()
    out["hs_paged_bitwise"] = torch.equal(got.full_tensor(), want)
    # an int8 pool: the codes DTensors, the scale plane a plain global
    # tensor that shards with its heads
    kq = torch.clamp(torch.round(c["k"] * 40), -127, 127).to(torch.int8)
    vq = torch.clamp(torch.round(c["v"] * 40), -127, 127).to(torch.int8)
    plane = torch.rand(c["k"].shape[0], c["k"].shape[1], 2,
                       generator=torch.Generator().manual_seed(3)) / 40
    got = sharded(dt(c["q"]), dt(kq), dt(vq), *args, plane)
    want = pfd.paged_flash_decode(c["q"], kq, vq, *args, plane)
    out["hs_int8_bitwise"] = torch.equal(got.full_tensor(), want)
    d = {k: torch.as_tensor(v) for k, v in cases["dense"].items()}
    sharded = head_sharded_kernel(fd.flash_decode, mesh)
    got = sharded(dt(d["q"]), dt(d["k"]), dt(d["v"]), d["cur"], d["pads"])
    want = fd.flash_decode(d["q"], d["k"], d["v"], d["cur"], d["pads"])
    out["hs_dense"] = got.full_tensor()
    out["hs_dense_bitwise"] = torch.equal(got.full_tensor(), want)
    out["hs_names"] = [sharded.__name__, sharded.__wrapped__.__name__]
    # GQA groups split across ranks: Hq 4 over Hkv 1
    out["hs_ratio"] = refusal(lambda: sharded(
        dt(d["q"]), dt(d["k"][:, :1].contiguous()),
        dt(d["v"][:, :1].contiguous()), d["cur"], d["pads"]))


class _Clock:
    """A stand-in for the engine module's ``time``: ``time()`` moves 10 s
    an engine iteration (``k``, counted by the caller), ``jump`` s more
    from the first iteration on (a clock stepped after submit), and
    ``idle`` s more (time that passes with no iteration)."""

    def __init__(self, jump: float):
        self.k, self.jump, self.idle = 0, jump, 0.0
        self.perf_counter, self.monotonic = _time.perf_counter, _time.monotonic
        self.sleep = _time.sleep

    def time(self) -> float:
        return 1000.0 + 10.0 * self.k + self.idle + \
            (self.jump if self.k >= 1 else 0.0)


def clock_case(out, L, flax, rank, GenerationEngine):
    """Deadline 35 s, 10 s an iteration; rank 1's clock jumps 10 s after
    submit, so read locally it expires the request one iteration early.
    Then the engine idles 100 s, and a request with the same deadline
    that needs two iterations is submitted: its limit runs from its
    submit."""
    from sparkdl_tpu_torch.serving import engine as E
    model = model_of(L, flax, L.LlamaConfig.tiny())
    real = E.time
    try:
        for arm, tp in (("tp2", 2), ("local", 1)):
            clock = E.time = _Clock(10.0 if rank == 1 else 0.0)
            eng = GenerationEngine.from_model(
                model, num_slots=1, max_len=64, prefill_chunk=8, tp=tp,
                device="cpu")
            inner = eng.step

            def step(_inner=inner, _clock=clock):
                _clock.k += 1
                return _inner()
            eng.step = step
            h = eng.submit([5, 6, 7, 8, 9], max_new_tokens=20,
                           deadline_s=35.0)
            eng.run_until_idle()
            out[f"clock_{arm}"] = [h.finish_reason, len(h.tokens),
                                   eng.stats["steps"], clock.k]
            clock.idle += 100.0
            h = eng.submit([5, 6, 7], max_new_tokens=2, deadline_s=35.0)
            eng.run_until_idle()
            out[f"clock_idle_{arm}"] = [h.finish_reason, len(h.tokens)]
    finally:
        E.time = real


def _front_engine(L, flax, GenerationEngine, **kw):
    model = model_of(L, flax, L.LlamaConfig.tiny())
    return GenerationEngine.from_model(
        model, num_slots=2, max_len=64, prefill_chunk=8, block_size=8,
        tp=2, device="cpu", **kw)


def _clients(submit, prompts, new, n=3) -> list:
    """``n`` closed-loop client threads over ``prompts`` (client k takes
    every n-th); the handles in prompt order."""
    hs = [None] * len(prompts)

    def client(k):
        for i in range(k, len(prompts), n):
            hs[i] = submit(prompts[i], new)
            hs[i].result(60)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return hs


def _by_prompt(handles, prompts) -> list:
    """``[finish_reason, tokens]`` of each prompt's request, the handles
    named by rank 0's ids on every rank."""
    got = {tuple(h.prompt): h for h in handles}
    return [[got[tuple(p)].finish_reason, list(got[tuple(p)].tokens)]
            for p in prompts]


def _until(pred, timeout=30.0):
    t0 = _time.time()
    while not pred():
        assert _time.time() - t0 < timeout, "timed out"
        _time.sleep(0.001)


def _threads_of_collectives(out, key, fn):
    """Run ``fn`` recording the threads that issue a collective."""
    import torch.distributed as dist
    names = set()
    saved = {n: getattr(dist, n) for n in (
        "broadcast", "all_reduce", "all_gather", "all_gather_into_tensor")}

    def wrap(f):
        def call(*a, **k):
            names.add(threading.current_thread().name)
            return f(*a, **k)
        return call
    for n, f in saved.items():
        setattr(dist, n, wrap(f))
    try:
        return fn()
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)
        out[key] = sorted(names)


def front_cases(out, L, flax, cases, rank, GenerationEngine):
    """The started engine's front: only rank 0 is asked, every rank
    streams what it was asked."""
    from sparkdl_tpu_torch.runner import chaos
    from sparkdl_tpu_torch.serving import EngineFleet

    c = cases["front"]
    prompts, new = c["prompts"], c["new"]
    lead = rank == 0

    # (a) three client threads on rank 0; rank 1 submits nothing
    eng = _front_engine(L, flax, GenerationEngine)
    seen = []

    def serve_a():
        eng.start(on_request=seen.append)
        if lead:
            hs = _clients(lambda p, n: eng.submit(p, max_new_tokens=n),
                          prompts, new)
            eng.stop(drain=True)
            return hs
        out["front_follower_submit"] = refusal(
            lambda: eng.submit(prompts[0], max_new_tokens=2))
        eng.stop()
        return seen
    hs = _threads_of_collectives(out, "front_threads", serve_a)
    out["front_streams"] = _by_prompt(hs, prompts)
    out["front_ids"] = sorted(h.id for h in hs)
    out["front_seen"] = sorted(h.id for h in seen)
    st = eng.snapshot()
    out["front_stats"] = [st["front"]["messages"],
                          st["front"]["idle_messages"], st["completed"]]

    # (b) a cancel and an expired deadline beside a request that completes
    eng = _front_engine(L, flax, GenerationEngine)
    seen = []
    eng.start(on_request=seen.append)
    if lead:
        long_, short = prompts[0], prompts[1]
        hc = eng.submit(long_, max_new_tokens=c["long"])
        hd = eng.submit(short, max_new_tokens=c["long"], deadline_s=0.02)
        hk = eng.submit(prompts[2], max_new_tokens=new)
        _until(lambda: len(hc.tokens) >= 2)
        threading.Thread(target=hc.cancel).start()
        hk.wait(60)
        eng.stop(drain=True)
        seen = [hc, hd, hk]
    else:
        eng.stop()
    out["cancel_streams"] = _by_prompt(seen, prompts[:3])
    out["cancel_state"] = [
        eng.stats["cancelled"], eng.stats["completed"],
        eng.backend.allocator.stats()["blocks_free"],
        sum(r is not None for r in eng._slots), len(eng._queue)]

    # (c) drain mid-stream, then resume on the same engine
    eng = _front_engine(L, flax, GenerationEngine)
    seen = []
    eng.start(on_request=seen.append)
    if lead:
        hs = [eng.submit(p, max_new_tokens=new) for p in prompts[:3]]
        _until(lambda: sum(len(h.tokens) for h in hs) >= 3)
        snaps = eng.drain()
    else:
        snaps = eng.drain()
    out["drain_snaps"] = [[s.id, s.state, list(s.tokens), s.delivered]
                          for s in snaps]
    eng.start(on_request=seen.append)
    if lead:
        for s in snaps:
            eng.resume(s)
        for h in hs:
            h.wait(60)
        eng.stop(drain=True)
    else:
        eng.stop()
    out["drain_streams"] = _by_prompt(seen, prompts[:3])

    # (d) a planned serving fault: the first decode step raises a lost
    # slot cache on every rank
    eng = _front_engine(L, flax, GenerationEngine)
    seen = []
    chaos.install(chaos.FaultPlan([chaos.Fault("serve_decode",
                                               "cache_lost", prob=1.0)]))
    try:
        eng.start(on_request=seen.append)
        if lead:
            seen = _clients(lambda p, n: eng.submit(p, max_new_tokens=n),
                            prompts[:4], new)
            eng.stop(drain=True)
        else:
            eng.stop()
    finally:
        chaos.uninstall()
    out["failover_streams"] = _by_prompt(seen, prompts[:4])
    out["failover_stats"] = [eng.stats["failovers"],
                             eng.stats["failover_resumed"],
                             eng.stats["completed"], eng._fatal is None]

    # (e) rank 0's fleet over [the fronted tp engine, a one-device engine]:
    # the tp replica drained mid-stream, its requests re-admitted
    eng = _front_engine(L, flax, GenerationEngine)
    drained = []
    if lead:
        one = GenerationEngine.from_model(
            model_of(L, flax, L.LlamaConfig.tiny()), num_slots=2,
            max_len=64, prefill_chunk=8, block_size=8, device="cpu")
        drain = eng.drain

        def record(timeout=None):
            snaps = drain(timeout)
            drained.extend([s.id, list(s.tokens)] for s in snaps)
            return snaps
        eng.drain = record
        fleet = EngineFleet([eng, one], names=["tp", "one"],
                            routing="round_robin")
        fleet.start()
        frs = [fleet.submit(p, max_new_tokens=new) for p in prompts[:4]]
        _until(lambda: any(len(f.tokens) >= 2 and f.replica == "tp"
                           for f in frs))
        fleet.doom_replica("tp")
        for f in frs:
            f.wait(60)
        fleet.stop()
        out["fleet_streams"] = [list(f.tokens) for f in frs]
        out["fleet_replicas"] = [f.replica for f in frs]
        out["fleet_stats"] = [fleet.stats["drains"],
                              fleet.stats["readmissions"],
                              fleet.stats["completed"]]
    else:
        eng.start()
        drained = [[s.id, list(s.tokens)] for s in eng.drain()]
    out["fleet_drained"] = drained


def _close_on(cue: str, srv, done: threading.Event) -> None:
    """Drop ``srv``'s channel without a drain once ``cue`` exists."""
    while not done.is_set():
        if os.path.exists(cue):
            srv.close()
            return
        _time.sleep(0.005)


def serve_rounds(out, make_engine, rank: int, tp: int, d: str, rounds,
                 authkey: bytes) -> None:
    """Each round a fresh engine on every rank. Rank 0 of group g serves
    one fleet (``FrontServer``), its address in ``<d>/<round>_<g>.addr``,
    and drops its channel without a drain if ``<d>/<round>_<g>.close``
    appears; the other ranks start and wait for rank 0's stop. Every rank
    records the snapshots the round's stop gave it and its engine's
    counts."""
    from sparkdl_tpu_torch.runner.events import atomic_write_json
    from sparkdl_tpu_torch.serving.remote import FrontServer

    group = rank // tp
    for rnd in rounds:
        eng = make_engine()
        if rank % tp == 0:
            srv = FrontServer(eng, ("127.0.0.1", 0), authkey,
                              accept_timeout_s=120.0)
            done = threading.Event()
            threading.Thread(target=_close_on, daemon=True, args=(
                os.path.join(d, f"{rnd}_{group}.close"), srv, done)).start()
            atomic_write_json(os.path.join(d, f"{rnd}_{group}.addr"),
                              list(srv.address))
            try:
                snaps = srv.serve()
            finally:
                done.set()
        else:
            eng.start()
            snaps = eng.drain()
        out[f"{rnd}_snaps"] = [[s.id, list(s.tokens), s.delivered]
                               for s in snaps]
        out[f"{rnd}_end"] = [eng.stats["cancelled"], eng.stats["completed"],
                             sum(r is not None for r in eng._slots),
                             len(eng._queue), eng._fatal is None]


def fleet_mode(in_dir: str, rank: int) -> dict:
    from sparkdl_tpu_torch import GenerationEngine
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.serving.backend import tp_mesh

    flax = torch.load(os.path.join(in_dir, "tiny.pt"), weights_only=False)
    c = torch.load(os.path.join(in_dir, "cases.pt"),
                   weights_only=False)["fleet"]
    model = model_of(L, flax, L.LlamaConfig.tiny())
    mesh = tp_mesh(2)

    def make():
        return GenerationEngine.from_model(
            model, mesh=mesh, device="cpu", **c["engine"])
    out = {}
    serve_rounds(out, make, rank, 2, in_dir, c["rounds"],
                 bytes.fromhex(c["authkey"]))
    return out


def card_fleet_mode(in_dir: str, rank: int) -> dict:
    from sparkdl_tpu_torch import GenerationEngine
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.ops import flash_attention as fa
    from sparkdl_tpu_torch.serving.backend import tp_mesh

    c = torch.load(os.path.join(in_dir, "cases.pt"),
                   weights_only=False)["fleet"]
    torch.backends.cuda.matmul.allow_tf32 = False
    model = L.LlamaModel(L.LlamaConfig(**c["cfg"]), device="cuda",
                         attn_fn=fa.flash_attention,
                         generator=torch.Generator(device="cuda")
                         .manual_seed(c["seed"]))
    mesh = tp_mesh(1)

    def make():
        return GenerationEngine.from_model(model, mesh=mesh, device="cuda",
                                           **c["engine"])
    out = {}
    serve_rounds(out, make, rank, 1, in_dir, c["rounds"],
                 bytes.fromhex(c["authkey"]))
    return out


def tp2_mode(in_dir: str, rank: int) -> dict:
    from sparkdl_tpu_torch import GenerationEngine
    from sparkdl_tpu_torch.models import llama as L

    flax = torch.load(os.path.join(in_dir, "tiny.pt"), weights_only=False)
    flax4 = torch.load(os.path.join(in_dir, "tp4.pt"), weights_only=False)
    flax_odd = torch.load(os.path.join(in_dir, "odd.pt"), weights_only=False)
    cases = torch.load(os.path.join(in_dir, "cases.pt"), weights_only=False)
    out = {}
    mesh_cases(out)
    from_model_cases(out, L, flax, GenerationEngine)
    lean_case(out, L, flax, cases, GenerationEngine)
    kernel_case(out, L, flax, cases, GenerationEngine)
    int8_case(out, L, flax, cases, GenerationEngine)
    budget_case(out, L, flax4, GenerationEngine)
    odd_case(out, L, flax_odd, cases, GenerationEngine)
    gating_case(out)
    head_sharded_case(out, cases)
    clock_case(out, L, flax, rank, GenerationEngine)
    front_cases(out, L, flax, cases, rank, GenerationEngine)
    return out


def matrix_mode(in_dir: str, rank: int) -> dict:
    from sparkdl_tpu_torch import GenerationEngine
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.serving.draft import HistoryDraft

    flax4 = torch.load(os.path.join(in_dir, "tp4.pt"), weights_only=False)
    c = torch.load(os.path.join(in_dir, "cases.pt"),
                   weights_only=False)["matrix"]
    cfg = L.LlamaConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=4, num_kv_heads=4, intermediate_size=256,
                        rope_theta=10000.0)
    model = model_of(L, flax4, cfg)
    from sparkdl_tpu_torch.serving.backend import tp_mesh
    out = {"groups": [tp_mesh(tp).mesh.tolist() for tp in (1, 2, 4)]}
    for paged in (True, False):
        for tp in (1, 2, 4):
            kw = dict(num_slots=2, max_len=64, prefill_chunk=8, tp=tp,
                      device="cpu")
            if paged:
                prov = HistoryDraft()
                for p, r in zip(c["prompts"], c["refs"]):
                    prov.observe(p, r)
                kw.update(block_size=8, prefill_budget=16, spec_k=3,
                          draft_provider=prov)
            eng = GenerationEngine.from_model(model, **kw)
            out[f"matrix_{paged}_{tp}"] = [
                serve(eng, c["prompts"], c["new"]),
                eng.kv_pool_device_bytes, eng.tp_degree]
    return out


def main(argv) -> int:
    mode, in_dir, out_dir = argv[1:4]
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    from sparkdl_tpu_torch.runner import XlaRunner
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang

    runner = XlaRunner(device="cuda" if mode == "card_fleet" else "cpu")
    rank = runner.gang.rank
    out = {"tp2": tp2_mode, "matrix": matrix_mode, "fleet": fleet_mode,
           "card_fleet": card_fleet_mode}[mode](in_dir, rank)
    out = {k: v.detach().clone() if torch.is_tensor(v) else v
           for k, v in out.items()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    leave_gang()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
