"""Functions the multi-rank tests run on each rank of a
`repro_torch.launch.mesh.RankPool`.

A rank process imports this module by name when it unpickles a task, so
it imports only torch, numpy and the port (no JAX: ranks never load it).
Each function builds its mesh inside the rank (SPMD), runs its case and
returns host values (numpy arrays, numbers), which the tests compare with
the JAX package's results computed once in the pytest process.
"""
import contextlib

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import CompressionConfig, get_arch
from repro_torch.data.synthetic import batch_for, image_batch
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as S
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import gemm_core as gc
from repro_torch.launch import engine as TE
from repro_torch.launch import mesh as M
from repro_torch.launch import train as T
from repro_torch.models.cnn import CNN, CNNSpec
from repro_torch.models.transformer import LM

ARCH = "internlm2-1.8b"
# the reference's sharded-training schedule: 10 steps through warm-up
# [0, 2), projection [2, 4), joint [4, 8) and cool-down [8, 10)
COMP = CompressionConfig(
    target_sparsity=0.25, bit_lower=4, bit_upper=16, warmup_steps=2,
    projection_periods=1, projection_steps=2, pruning_periods=2,
    pruning_steps=2, cooldown_steps=2)
STEPS = 10
TINY_CNN = CNNSpec("tiny-vgg", "vgg", [16, 16], fc_dim=32, in_hw=8)


def _np(x):
    return x.detach().cpu().numpy()


# ------------------------------------------------------------- kernels
def tp_gemm_case(tp: int, x, w, epi_name: str, operands: tuple,
                 bits: int = 0):
    """(tp_gemm's output, the 1-rank gemm's) on this rank, as numpy."""
    mesh = M.make_tp_mesh(tp)
    if not mesh.member:
        return None
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    ops = tuple(torch.as_tensor(v) for v in operands)
    epi = gc.Epilogue(epi_name, ops, bits)
    return _np(gc.tp_gemm(x, w, epi, mesh=mesh)), _np(gc.gemm(x, w, epi))


def tp_decode_case(tp: int, q, k, v, pos):
    mesh = M.make_tp_mesh(tp)
    if not mesh.member:
        return None
    q, k, v, pos = map(torch.from_numpy, (q, k, v, pos))
    return (_np(da.tp_decode_attn(q, k, v, pos, mesh=mesh)),
            _np(da.decode_attn(q, k, v, pos)))


def tp_kernels_card(tp: int, seed: int = 0):
    """On the card: `tp_gemm` at small-M (M 4) and tensor-core (M 64,
    bf16 x) heights in fake_quant_rhs, dequant and unpack_dequant b4, and
    `tp_decode_attn`, each against the 1-rank kernel call on the same
    inputs: {case: whether bitwise equal}."""
    mesh = M.make_tp_mesh(tp)
    if not mesh.member:
        return None
    from repro_torch.core.quant import pack_codes
    dev = M.rank_device()
    gen = torch.Generator(device=dev).manual_seed(seed)
    K, N, out = 1024, 768, {}
    w = torch.randn(K, N, generator=gen, device=dev).to(torch.bfloat16)
    codes = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int32)
    scale = torch.rand(N, generator=gen, device=dev) + 0.5
    d, q_m, t = (torch.tensor(v, device=dev) for v in (0.01, 2.0, 1.0))
    cases = {"fake_quant_rhs": (w, gc.fake_quant_rhs(d, q_m, t)),
             "dequant": (codes.to(torch.int8), gc.dequant(scale)),
             "unpack_b4": (pack_codes(torch.clamp(codes, -8, 7), 4),
                           gc.unpack_dequant(4, scale))}
    for M_, dt in ((4, torch.bfloat16), (64, torch.bfloat16)):
        x = torch.randn(M_, K, generator=gen, device=dev).to(dt)
        for name, (w_, epi) in cases.items():
            y = gc.tp_gemm(x, w_, epi, mesh=mesh)
            out[f"{gc.variant(M_, dt)}.{name}"] = bool(
                torch.equal(y, gc.gemm(x, w_, epi)))
    B, S, KVh, g, dh = 4, 256, 8, 2, 128
    q = torch.randn(B, KVh, g, dh, generator=gen, device=dev)
    k = torch.randn(B, S, KVh, dh, generator=gen, device=dev)
    v = torch.randn(B, S, KVh, dh, generator=gen, device=dev)
    pos = torch.tensor([255, 7, 100, 64], device=dev)
    out["decode_attn"] = bool(torch.equal(
        da.tp_decode_attn(q, k, v, pos, mesh=mesh),
        da.decode_attn(q, k, v, pos)))
    return out


def tp_rejects(kind: str) -> str:
    """The message of the ValueError the wrapper raises on a shape the
    ranks do not divide."""
    mesh = M.make_tp_mesh(4)
    try:
        if kind == "gemm":
            gc.tp_gemm(torch.zeros(4, 32), torch.zeros(32, 66), gc.none(),
                       mesh=mesh)
        else:
            da.tp_decode_attn(torch.zeros(1, 3, 2, 8),
                              torch.zeros(1, 16, 3, 8),
                              torch.zeros(1, 16, 3, 8),
                              torch.zeros(1, dtype=torch.int64), mesh=mesh)
    except ValueError as e:
        return str(e)
    return ""


def mesh_case(n: int):
    """make_tp_mesh(n)'s shape and this rank's coordinate, and the error
    of a mesh wider than the world."""
    mesh = M.make_tp_mesh(n)
    try:
        M.make_tp_mesh(M.world()[1] + 1)
        err = ""
    except ValueError as e:
        err = str(e)
    return mesh.shape, (mesh.coords if mesh.member else None), err


# -------------------------------------------------------------- engine
def _use_weights(np_params, prompts):
    """Serve the given init params and prompts (the JAX package's) from
    this rank's `LM.init` and `synthetic_prompts`."""
    LM.init = lambda self, gen: convert.params_from_numpy(
        np_params, device=gen.device)
    TE.synthetic_prompts = lambda cfg, lens, seed=0: [
        np.asarray(p) for p in prompts]


def serve_tp(np_params, prompts, lens, gen, tp: int, kw: dict):
    """engine_serve's tokens on the first tp ranks (None past them) and
    rank 0's stats, with the given weights and prompts."""
    _use_weights(np_params, prompts)
    st: dict = {}
    out = TE.engine_serve(ARCH, True, list(lens), gen, verbose=False,
                          device="cpu", tp=tp, stats=st, **kw)
    if M.world()[0] >= tp:
        return None
    return {int(k): v for k, v in out.items()}, st


def serve_cases(np_params, prompts: dict, gen: int, cases: dict,
                tps=(2, 4)):
    """`serve_tp` for every case (name -> (lens, engine keywords)) at
    every tp: {(name, tp): (tokens, stats) or None}."""
    return {(name, tp): serve_tp(np_params, prompts[name], lens, gen, tp,
                                 kw)
            for name, (lens, kw) in cases.items() for tp in tps}


def engine_bytes(tp: int, kw: dict):
    """A built tp engine's byte counts and meta on this rank."""
    mesh = M.make_tp_mesh(tp)
    if not mesh.member:
        return None
    eng, _ = TE.build_engine(ARCH, True, device="cpu", mesh=mesh, **kw)
    leaves = [c for a in eng._arenas() for c in a.values()]
    return {"param": eng.param_bytes(),
            "param_per": eng.param_bytes(per_device=True),
            "kv": eng.kv_bytes(), "kv_per": eng.kv_bytes(per_device=True),
            "pool": sum(eng._leaf_nbytes(c, False) for c in leaves),
            "pool_per": sum(eng._leaf_nbytes(c, True) for c in leaves),
            "fallbacks": sorted({n for n, _, _ in eng.tp_fallbacks}),
            "meta": eng.serving_meta["tp"]}


# --------------------------------------------------------- collectives
def collectives_case(x, g, ef_in=None):
    """compressed_psum of this rank's row of x, ordered_sum of it, and
    compressed_grad_allreduce of {"w": g} on a (world, 1) mesh."""
    mesh = M.make_host_mesh()
    row = torch.from_numpy(x[mesh.coords["data"]])
    grads = {"w": torch.from_numpy(g)}
    mean, ef = C.compressed_grad_allreduce(grads, mesh, axis_names=("data",))
    return (_np(C.compressed_psum(row, mesh, "data")),
            _np(C.ordered_sum(row, mesh, "data")), _np(mean["w"]),
            _np(ef["w"]))


def shard_roundtrip(shape, spec, axes_shape):
    """local_shard then gather_full of an arange on a mesh of
    `axes_shape` over (data, model): (this rank's piece, the gathered)."""
    mesh = M.make_mesh(axes_shape, ("data", "model"))
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
        shape)
    piece = S.local_shard(full, tuple(spec), mesh)
    return _np(piece), _np(S.gather_full(piece, tuple(spec), mesh))


# ------------------------------------------------------------ training
def _host_state(params, qparams, qstate):
    return ({k: _np(v) for k, v in params.items()},
            {k: (float(q.d), float(q.q_m), float(q.t))
             for k, q in qparams.items()},
            {"redundant": {k: _np(v) for k, v in qstate.redundant.items()},
             "keep_mask": {k: _np(v) for k, v in qstate.keep_mask.items()},
             "step": qstate.step})


def sharded_train(n: int, fsdp: bool, grad_slices: int, model: str = "lm",
                  steps: int = STEPS, check_replicas: bool = True,
                  device="cpu"):
    """`steps` sharded GETA steps on the first n ranks ((n, 1) mesh) of
    the reference's parity run (internlm2 smoke or the tiny CNN, momentum,
    lr 3e-3): (losses, params, qparams, masks) gathered in full; every
    rank's control state is checked identical. None past the n ranks.
    The state is drawn on the CPU and copied to `device`."""
    mesh = M.make_subset_mesh(n)
    if not mesh.member:
        return None
    lm = LM(get_arch(ARCH, smoke=True)) if model == "lm" else CNN(TINY_CNN)
    params = {k: v.to(device) for k, v in
              lm.init(torch.Generator().manual_seed(0)).items()}
    axes = lm.param_axes() if model == "lm" else {}
    qparams = lm.init_qparams(params, bits_init=16.0)
    _, qasso = T.build_geta(lm, COMP, lr=3e-3, base_optimizer="momentum")
    qstate = qasso.init(params, qparams)
    plan = S.make_plan(mesh, fsdp=fsdp)
    p_sh = plan.shardings(axes, {k: tuple(v.shape)
                                 for k, v in params.items() if k in axes})
    step, (psh, qsh, ssh, bsh) = T.make_sharded_geta_train_step(
        lm, qasso, mesh, params, qparams, param_shardings=p_sh or None,
        grad_slices=grad_slices)
    params, qstate = S.place(params, psh), S.place(qstate, ssh)
    sharded = [k for k, v in psh.items() if any(v.spec)]
    losses = []
    for i in range(steps):
        b = (batch_for(lm.cfg, 0, i, 4, 16) if model == "lm"
             else image_batch(0, i, 8, hw=8))
        b = {k: v.to(device) for k, v in b.items()}
        params, qparams, qstate, m = step(params, qparams, qstate,
                                          S.place(b, bsh))
        losses.append(float(m["loss"]))
    if check_replicas and mesh.size > 1:
        for k, v in {**qstate.redundant, **qstate.keep_mask}.items():
            C.assert_replicated(v, mesh, k)
        for k, q in qparams.items():
            C.assert_replicated(torch.stack([q.d, q.q_m, q.t]), mesh, k)
    params = S.gather_tree(params, psh)
    return (losses, *_host_state(params, qparams, qstate), sharded)


def train_cases(cases):
    """`sharded_train(*case)` for every case: {case: result or None}."""
    return {case: sharded_train(*case) for case in cases}


# ---------------------------------------------------------- checkpoint
def serve_card(tp: int, lens, gen: int, kw: dict):
    """The smoke config's (f32) engine_serve tokens on this rank's card at
    tp (None past the tp ranks) and rank 0's decode mode."""
    st: dict = {}
    out = TE.engine_serve(ARCH, True, list(lens), gen, verbose=False, tp=tp,
                          stats=st, **kw)
    if M.world()[0] >= tp:
        return None
    return {int(k): v for k, v in out.items()}, st["decode_mode"]


def save_sharded(directory: str, n: int):
    """Save at step 1, from the first n ranks, a tree whose "w" is
    sharded over the data axis of an (n, 1) mesh: each rank holds its
    rows, the save gathers them and the mesh's first rank writes."""
    mesh = M.make_subset_mesh(n)
    if not mesh.member:
        M.make_host_mesh().barrier()
        return None
    sh = {"w": S.NamedSharding(mesh, ("data", None)), "n": None}
    full = {"w": torch.arange(32.0).reshape(8, 4).to(torch.bfloat16),
            "n": 7}
    local = S.place(full, sh)
    gathered = S.gather_tree(local, sh)
    if mesh.rank == 0:
        save_checkpoint(directory, 1, gathered)
    M.make_host_mesh().barrier()
    return _np(local["w"].float())


def restore_sharded(directory: str, n: int):
    """Restore that checkpoint on the first n ranks, each leaf as this
    rank's shard of an (n, 1) mesh: (rows, dtype name, n)."""
    mesh = M.make_subset_mesh(n)
    if not mesh.member:
        return None
    sh = {"w": S.NamedSharding(mesh, ("data", None)), "n": None}
    example = {"w": torch.zeros(8 // n, 4), "n": 0}
    tree, step = restore_checkpoint(directory, example, shardings=sh)
    return _np(tree["w"].float()), str(tree["w"].dtype), tree["n"], step



# ------------------------------------------ every family across ranks
def _block_mesh(n: int, shape: str):
    """(block index, mesh) of this rank's block of n consecutive ranks:
    the world cut into world // n blocks, each a (1, n) tensor-parallel
    (`shape` "tp") or (n, 1) data-parallel ("dp") mesh, so blocks run
    cases side by side. Every rank builds every block's mesh in one order
    (process groups are made collectively); None past the blocks."""
    mine = None
    for b in range(M.world()[1] // n):
        mesh = M._build((1, n) if shape == "tp" else (n, 1), M.AXES,
                        tuple(range(b * n, (b + 1) * n)))
        if mesh.member:
            mine = (b, mesh)
    return mine


def on_blocks(cases: list, shape: str, fn, *args) -> dict:
    """fn(case, mesh, *args) for every case (a tuple whose first entry is
    its rank count n), the cases of one n dealt over the world's blocks
    of n ranks: {case: this rank's result} for its blocks' cases."""
    out = {}
    for n in sorted({c[0] for c in cases}):
        mine = _block_mesh(n, shape)
        if mine is None:
            continue
        b, mesh = mine
        of_n = [c for c in cases if c[0] == n]
        for case in of_n[b::M.world()[1] // n]:
            out[case] = fn(case, mesh, *args)
    return out


@contextlib.contextmanager
def _weights(np_params: dict):
    """Inside, `LM.init` hands over `np_params` (the JAX package's)."""
    init = LM.init
    LM.init = lambda self, gen: convert.params_from_numpy(
        np_params, device=gen.device)
    try:
        yield
    finally:
        LM.init = init


def _family(arch, np_params: dict):
    """(the smoke LM of `arch`, `np_params` as its params)."""
    return (LM(get_arch(arch, smoke=True)),
            convert.params_from_numpy(np_params))


SHARD_KEYS = ("moe.we_gate", "moe.router", "mamba.conv_w", "rwkv.u",
              "rwkv.wr", "rwkv.cm_k")
STATE_KEYS = (".h", ".conv", ".wkv", ".tm_shift")


def _serve_case(case, mesh, np_params: dict, prompts: dict, gen: int):
    """One engine case (n, arch, name, kw) on `mesh` (None: one rank):
    (tokens by request, tp fallbacks, {param or arena leaf: this rank's
    shape} for the expert, channel, head and state leaves)."""
    _, arch, name, kw = case
    lens = [len(p) for p in prompts[arch]]
    with _weights(np_params[arch]):
        eng, _ = TE.build_engine(arch, True, max_seq=max(lens) + gen,
                                 device="cpu", mesh=mesh, **dict(kw))
    for p in prompts[arch]:
        eng.submit(np.asarray(p), gen)
    eng.warmup()
    out = eng.run()
    shapes = {k: tuple(v.shape) for k, v in eng.params.items()
              if k.startswith("blocks.") and k.endswith(SHARD_KEYS)}
    shapes.update({k: tuple(v.shape) for k, v in eng.caches.items()
                   if k.endswith(STATE_KEYS)})
    return ({int(r): np.asarray(t) for r, t in out.items()},
            sorted({n for n, _, _ in eng.tp_fallbacks}), shapes)


def serve_families(np_params: dict, prompts: dict, gen: int, cases: list):
    """Every engine case (tp, arch, name, engine keywords as a tuple of
    items) on blocks of tp ranks: {case: this rank's (tokens, fallbacks,
    shard shapes)}."""
    return on_blocks(cases, "tp", _serve_case, np_params, prompts, gen)


def _layer_case(case, mesh, np_params: dict, x: np.ndarray, states: dict):
    """One sublayer (n, arch, kind) on the rank's shards of a (1, n) mesh
    against the whole 1-rank call on the same inputs, 8-bit quantizers:
    (max |tp - whole| over outputs and states, max |whole|, {leaf: local
    shape})."""
    from repro_torch.models import layers as Lyr
    _, arch, kind = case
    lm, params = _family(arch, np_params[arch])
    cfg = lm.cfg
    qp = lm.init_qparams(params)
    plan = S.serving_plan(mesh, cfg)
    specs = S.serving_param_specs(plan, lm.param_axes(), params)
    tp = S.TensorParallel(mesh, specs)
    whole = {k: v[0] for k, v in params.items() if k.startswith("blocks.")}
    local = {k: S.local_shard(v, specs[k], mesh)[0]
             for k, v in params.items() if k.startswith("blocks.")}
    pre = {"moe": "blocks.1.moe" if cfg.mamba else "blocks.0.moe",
           "mamba": "blocks.1.mamba", "rwkv": "blocks.0.rwkv",
           "chanmix": "blocks.0.rwkv"}[kind]
    xt = torch.from_numpy(x)
    # the state before and after the call, sharded as the arena shards it
    st_full = tuple(torch.from_numpy(s) for s in states.get(kind, ()))
    names = {"mamba": ("h", "conv"), "rwkv": ("tm_shift", "wkv"),
             "chanmix": ("cm_shift",)}.get(kind, ())
    st_specs = list(S.kv_cache_specs(mesh, {
        f"blocks.0.{n}": (1,) + tuple(s.shape)
        for n, s in zip(names, st_full)}).values())
    st_local = tuple(S.local_shard(s[None], sp, mesh)[0]
                     for s, sp in zip(st_full, st_specs))

    def call(lp, t, state):
        if kind == "moe":
            return (Lyr.moe_apply(lp, qp, cfg, xt, prefix=pre, tp=t),)
        if kind == "chanmix":
            return Lyr.rwkv_chanmix_apply(lp, qp, cfg, xt, prefix=pre, tp=t,
                                          state=state[0] if state else None)
        fn = Lyr.mamba_apply if kind == "mamba" else Lyr.rwkv_timemix_apply
        out, new = fn(lp, qp, cfg, xt, prefix=pre, tp=t, state=state or None)
        return (out, *new)

    got = call(local, tp, st_local)
    want = call(whole, None, st_full)
    err, big = 0.0, 0.0
    for g, w, sp in zip(got, want, [()] + st_specs):
        w = S.local_shard(w[None], sp, mesh)[0]
        err = max(err, float((g - w).abs().max()))
        big = max(big, float(w.abs().max()))
    shapes = {k: tuple(v.shape) for k, v in local.items()
              if k.startswith(pre) and k.endswith(SHARD_KEYS)}
    shapes.update({f"state.{i}": tuple(s.shape)
                   for i, s in enumerate(st_local)})
    return err, big, shapes


def layer_families(np_params: dict, x: np.ndarray, states: dict,
                   cases: list):
    """Every sublayer case (tp, arch, kind) on blocks of tp ranks."""
    return on_blocks(cases, "tp", _layer_case, np_params, x, states)


def _train_case(case, mesh, np_params: dict, np_qparams: dict,
                batches: dict):
    """One GETA step (n, arch, fsdp, grad_slices) from the reference's
    params, 16-bit quantizers and batch, under `train.JOINT_STEP0` with
    the arch's base optimizer, on an (n, 1) mesh (the 1-rank step with
    grad_slices=k when n is 1): (loss, params gathered whole, qparams,
    masks, the sharded leaves) and, on one rank, the ordered loss and
    gradients (loss, gx, gq) the step's QASSO update takes."""
    from repro_torch.configs import get_overrides
    n, arch, fsdp, k = case
    lm, params = _family(arch, np_params[arch])
    qparams = convert.qparams_from_numpy(np_qparams[arch])
    _, qasso = T.build_geta(lm, T.JOINT_STEP0, lr=3e-4,
                            base_optimizer=get_overrides(arch).get(
                                "base_optimizer", "adamw"))
    qstate = qasso.init(params, qparams)
    # the arch's rules, but FSDP only where the case asks for it (the
    # large archs' rules turn it on)
    rules = {k_: v for k_, v in get_overrides(arch).items() if k_ != "fsdp"}
    plan = S.make_plan(mesh, fsdp=fsdp, overrides=rules)
    p_sh = plan.shardings(lm.param_axes(), {k_: tuple(v.shape)
                                            for k_, v in params.items()})
    step, (psh, _, ssh, bsh) = T.make_sharded_geta_train_step(
        lm, qasso, mesh, params, qparams, param_shardings=p_sh,
        grad_slices=k)
    batch = {k_: torch.from_numpy(v) for k_, v in batches[arch].items()}
    grads = None
    if n == 1:
        lg = T.make_ordered_loss_grads(lm, mesh, grad_slices=k)
        loss, gx, gq = lg(params, qparams, batch)
        grads = (float(loss), {k_: _np(g) for k_, g in gx.items()},
                 {k_: (float(q.d), float(q.q_m), float(q.t))
                  for k_, q in gq.items()})
    params, qstate = S.place(params, psh), S.place(qstate, ssh)
    params, qparams, qstate, m = step(params, qparams, qstate,
                                      S.place(batch, bsh))
    if mesh.size > 1:
        for k_, v in {**qstate.redundant, **qstate.keep_mask}.items():
            C.assert_replicated(v, mesh, k_)
    sharded = sorted(k_ for k_, v in psh.items() if any(v.spec))
    params = S.gather_tree(params, psh)
    return (float(m["loss"]), *_host_state(params, qparams, qstate),
            sharded, grads)


def train_families(np_params: dict, np_qparams: dict, batches: dict,
                   cases: list):
    """Every step case (n, arch, fsdp, grad_slices) on blocks of n
    ranks: {case: this rank's result}."""
    return on_blocks(cases, "dp", _train_case, np_params, np_qparams,
                     batches)


def _loop_case(case, mesh):
    """`train_loop` for one step of (n, arch, fsdp) on an (n, 1) mesh
    from its own init: (the loss, whether the params are finite)."""
    _, arch, fsdp = case
    state, _, _, losses = T.train_loop(arch, True, 1, 4, 16, mesh=mesh,
                                       fsdp=fsdp, verbose=False,
                                       device="cpu")
    return losses[0], all(bool(torch.isfinite(v.float()).all())
                          for v in state["params"].values())


def loop_families(cases: list):
    return on_blocks(cases, "dp", _loop_case)


def _family_state(arch: str, n: int, mesh):
    """The smoke `arch`'s params from `LM.init` (seed 0) and their FSDP
    shardings on `mesh` (embed over the data axis of n ranks)."""
    from repro_torch.configs import get_overrides
    lm = LM(get_arch(arch, smoke=True))
    params = lm.init(torch.Generator().manual_seed(0))
    plan = S.make_plan(mesh, fsdp=True, overrides=dict(get_overrides(arch)))
    return params, plan.shardings(lm.param_axes(), {
        k: tuple(v.shape) for k, v in params.items()})


def save_family(directory: str, n: int, arch: str):
    """Save at step 1 from the first n ranks the FSDP-sharded params of
    `arch`: gathered whole, written by the mesh's first rank."""
    mesh = M.make_subset_mesh(n)
    if not mesh.member:
        M.make_host_mesh().barrier()
        return None
    params, sh = _family_state(arch, n, mesh)
    local = S.place(params, sh)
    whole = S.gather_tree(local, sh)
    if mesh.rank == 0:
        save_checkpoint(directory, 1, whole)
    M.make_host_mesh().barrier()
    return sorted(k for k, v in sh.items() if any(v.spec))


def restore_family(directory: str, n: int, arch: str):
    """Restore it on the first n ranks under this mesh's FSDP shardings:
    (every leaf bitwise this rank's shard of the params, the sharded
    leaves' local shapes)."""
    mesh = M.make_subset_mesh(n)
    if not mesh.member:
        return None
    params, sh = _family_state(arch, n, mesh)
    tree, _ = restore_checkpoint(directory, params, shardings=sh)
    want = S.place(params, sh)
    return (all(torch.equal(tree[k], want[k]) for k in want),
            {k: tuple(tree[k].shape) for k, v in sh.items() if any(v.spec)})
