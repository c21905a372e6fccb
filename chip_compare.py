"""Numbers for comparing two trees of the port on one GPU.

    python3 chip_compare.py TAG            # from a tree's root
    python3 chip_compare.py TAG --splits   # and bf16 B6b's row slices
    python3 chip_compare.py TAG --masks    # the keep-mask readings alone
    python3 chip_compare.py TAG --attention  # the attention readings alone

Run from the root of a checkout; it imports that checkout's `chip_smoke`
and `weathermodel_tpu_torch`, so the same file compares an older tree too
(`python3 /path/to/chip_compare.py parent` from the older tree's root). To
compare a parent with a change, run it from both roots in turns on one card,
in one machine session: parent, change, change, parent.

It prints progress lines and last one line `RESULT {json}` holding TAG and:
  - the bf16 grouped matmul body's outputs and CUDA-event ms (20 calls after
    3 warm-up): B4 (forward and d_lhs) and B4t at the MoE microbatch's
    shapes (S = 70080 rows in 8 groups, 576 x 2304 and back), P3 at each arm
    of the probe, each output as the first 16 hex digits of its bytes'
    SHA-256 (equal digits: equal bits);
  - bf16 B6b at the bench microbatch (M = 105120, H = 576, F = 2304, dropout
    0.1) and bf16 B5 at B = 256, T = 365, H = 576: CUDA-event ms;
  - the probes P1 and P2 at the ablation script's shape (B = 224, T = 384,
    16 heads of 36), on the columns they write, and the bf16 attention bodies
    B3f and B3b (B = 256, T = 365, H = 200, 10 heads) and B2 (B = 288,
    H = 576, 16 heads), dropout 0.1: output hashes and CUDA-event ms;
  - the port's bench (WeatherBERT-large, 2 x 288, bf16, dropout 0.1, 3
    warm-up + 3 timed steps) with BENCH_FFN_IMPL torch, fused_ffn_ln and
    fused_ffn, and BENCH_ATTENTION=fused_qkv_op in eval: samples/s;
  - `wm-pretrain-torch`'s run for chip_smoke's `train`, `train_moe` and
    `train_former` configurations, 2 epochs on its synthetic store: epoch
    2's median samples/s;
  - the keep-mask family at the bench microbatch's FFN hidden site, rate
    0.1: B9b and B9p at [105120, 2304], B8m and B8 (bf16, fp32) at the lane
    view of [288, 365, 2304]: output hashes and CUDA-event ms; the bench's
    `torch` FFN under `set_impl("maskgen")` (samples/s, and one profiled
    step's device time of B9p and of the unpack and apply kernels around it)
    and `set_impl("maskgen_bool")` (samples/s, and one profiled step's B9b
    device time); and the SASS of the tree's
    `csrc/keep_mask.cu` (built alone into a cubin, read with cuobjdump):
    the instructions a kernel runs on its hot path, per element, by pipe.
With --splits, also bf16 B6b's time and its passes' device ms (one profile
of 3 calls) at the row slices `ops.fused_ffn_ln._wgrad_splits` picks and at
other counts (dW1's, dW2's). With --masks, only the keep-mask family's
hashes, times and SASS. With --attention, only B3f, B3b and B2 in bf16 and in
fp32 (keys "fp32 B3f hash" and so on; the fp32 forms also at the yield step's
64 x 364) and the yield train step (chip_smoke.py's `_yield_profile` model
and batch: WeatherFormer-small, ELBO, batch 64, T = 364, dropout 0.1) in
fp32 and bf16: the median host ms of 20 steps, each ending in the loss's
read, and windows/s.
"""

import hashlib
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
import tempfile
from pathlib import Path

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# S = 70080 routed rows of a top-2 routing at the MoE microbatch
# (chip_smoke.py's kernel_gmm), by expert
GROUPS = [9450, 9262, 8806, 8900, 8668, 8043, 8333, 8618]
# B6b's row slices (dW1's, dW2's) timed beside the wrapper's own
SPLITS = [(5, 4), (11, 22), (22, 22), (22, 44), (6, 7), (2, 2), (33, 27)]


def digest(t):
    """The first 16 hex digits of the SHA-256 of t's bytes."""
    data = t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(data).hexdigest()[:16]


def grouped_matmul(out):
    from weathermodel_tpu_torch.ops import blocked_mm as bmm
    from weathermodel_tpu_torch.ops.gmm import gmm, tgmm
    from weathermodel_tpu_torch.scripts import abl_gemm_probe

    g = torch.Generator(device="cuda").manual_seed(123)
    gs = torch.tensor(GROUPS, device="cuda")
    s = sum(GROUPS)
    for k, n in ((576, 2304), (2304, 576)):
        lhs = torch.randn(s, k, device="cuda", generator=g).to(torch.bfloat16)
        rhs = (torch.randn(8, k, n, device="cuda", generator=g)
               / k ** 0.5).to(torch.bfloat16)
        dy = torch.randn(s, n, device="cuda", generator=g).to(torch.bfloat16)
        for name, fn in (("B4", lambda: gmm(lhs, rhs, gs)),
                         ("B4 dlhs", lambda: gmm(dy, rhs, gs, trans_rhs=True)),
                         ("B4t", lambda: tgmm(lhs, dy, gs))):
            out[f"{name} {k}x{n} hash"] = digest(fn())
            out[f"{name} {k}x{n} ms"] = cs._cuda_ms(fn, iters=20, warmup=3)
    x, w = abl_gemm_probe.inputs(abl_gemm_probe.M, "cuda")
    for bm, bn in abl_gemm_probe.ARMS:
        rows, cols = bmm.covered(x.shape[0], w.shape[1], bm, bn)
        out[f"P3 {bm},{bn} hash"] = digest(
            bmm.blocked_mm(x, w, bm, bn)[:rows, :cols])
        out[f"P3 {bm},{bn} ms"] = cs._cuda_ms(
            lambda: bmm.blocked_mm(x, w, bm, bn), iters=20, warmup=3)


def ffn_bwd_args():
    t = cs._ffn_inputs(cs.FFN_ROWS, 576, 2304, torch.bfloat16, cs.SEED + 7)
    return t, (t["x"], t["w1"], t["b1"], t["w2"], t["b2"], t["ls"], t["lb"],
               t["do"], cs.DROPOUT, cs.FFN_SEEDS)


def kernels(out):
    from weathermodel_tpu_torch.ops.fused_ffn_ln import fused_ffn_ln_bwd
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention_outproj,
    )

    _, args = ffn_bwd_args()
    out["B6b ms"] = cs._cuda_ms(lambda: fused_ffn_ln_bwd(*args), iters=10)
    del args
    x, w, b = cs._attention_inputs(cs.BATCH, cs.SEQ_LEN, 576, cs.SEED)
    wo, bo = cs._outproj_weights(x)
    b5 = tuple(a.to(torch.bfloat16) for a in (x, w, b, wo, bo))
    out["B5 ms"] = cs._cuda_ms(lambda: fused_qkv_attention_outproj(*b5, 16),
                               iters=10)


def probes_and_attention(out):
    from weathermodel_tpu_torch.ops.headpack import headpack_v0, headpack_v1
    from weathermodel_tpu_torch.scripts import abl_headpack

    def reading(name, fn):
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        out[f"{name} hash"] = ",".join(digest(a) for a in got)
        out[f"{name} ms"] = cs._cuda_ms(fn, iters=20, warmup=3)

    q, k, v = abl_headpack.inputs(abl_headpack.B, "cuda")
    live = abl_headpack.LIVE  # the columns P2 writes: heads 0-14
    reading("P1", lambda: headpack_v0(q, k, v))
    reading("P2", lambda: headpack_v1(q, k, v)[..., :live])
    del q, k, v
    attention(out, (torch.bfloat16,))


def attention(out, dtypes=(torch.bfloat16, torch.float32)):
    """B3f and B3b (B = 256, T = 365, H = 200, 10 heads) and B2 (B = 288,
    H = 576, 16 heads), dropout 0.1, in each of `dtypes`: output hashes and
    CUDA-event ms (fp32 keys prefixed "fp32 "; fp32 B3f and B3b also at
    B = 64, T = 364)."""
    from weathermodel_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention_bwd,
    )

    for dtype in dtypes:
        tag = "" if dtype == torch.bfloat16 else "fp32 "
        g = torch.Generator(device="cuda").manual_seed(77)

        def rand(*shape):
            return torch.randn(*shape, device="cuda", generator=g).to(dtype)

        def reading(name, fn, iters=20):
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            out[f"{tag}{name} hash"] = ",".join(digest(a) for a in got)
            out[f"{tag}{name} ms"] = cs._cuda_ms(fn, iters=iters, warmup=3)

        shapes = [(256, 365, "")]
        if dtype == torch.float32:
            shapes.append((64, 364, " 64x364"))
        for b, t, label in shapes:
            qkv, do = rand(b, t, 600), rand(b, t, 200)
            q, k, v = qkv.chunk(3, dim=-1)
            reading("B3f" + label,
                    lambda: flash_attention_fwd(q, k, v, 10, cs.DROPOUT, 7))
            reading("B3b" + label, lambda: flash_attention_bwd(
                q, k, v, do, 10, cs.DROPOUT, 7))
            del qkv, do, q, k, v
        qkv, do = rand(288, 365, 1728), rand(288, 365, 576)
        reading("B2", lambda: fused_qkv_attention_bwd(qkv, do, 16, cs.DROPOUT,
                                                      7), iters=10)
        del qkv, do
        torch.cuda.empty_cache()


def yield_step(out):
    """The yield train step in fp32 and bf16: median host ms of 20 steps
    after 3 warm-up ones, each ending in the loss's read, and windows/s."""
    from weathermodel_tpu_torch.train.state import make_optimizer
    from weathermodel_tpu_torch.train.yield_trainer import (
        make_yield_train_step,
    )

    for dtype in ("float32", "bfloat16"):
        model = cs._yield_model("flash", dtype, "cuda")
        step = make_yield_train_step(model, make_optimizer(model), "elbo",
                                     1e-4)
        batch = cs._yield_batch(cs.YIELD_BATCH, "cuda", cs.SEED + 6)
        gen = torch.Generator().manual_seed(cs.SEED)
        times = []
        for i in range(23):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(step(batch, gen, 1e-4)["total_loss"])
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        ms = sorted(times)[len(times) // 2]
        out[f"yield {dtype} step ms"] = ms
        out[f"yield {dtype} windows/s"] = cs.YIELD_BATCH / ms * 1e3
        print(out["tree"], dtype, "yield step", ms, flush=True)


def splits(out):
    from weathermodel_tpu_torch.ops import fused_ffn_ln as b6

    t, args = ffn_bwd_args()
    picked = b6._wgrad_splits
    h, f, sms = 576, 2304, torch.cuda.get_device_properties(
        0).multi_processor_count
    own = (picked(cs.FFN_ROWS, h, f, sms, True),
           picked(cs.FFN_ROWS, f, h, sms, True))
    try:
        for pair in [own, *SPLITS]:
            b6._wgrad_splits = (lambda m, k, n, sms, bf16, pair=pair:
                                pair[0] if k == h else pair[1])
            key = f"B6b splits {pair[0]},{pair[1]}"
            out[key + " ms"] = cs._cuda_ms(lambda: b6.fused_ffn_ln_bwd(*args),
                                           iters=10)
            out[key + " passes"] = cs._ffn_bwd_split(t, cs.DROPOUT)
            print(key, out[key + " ms"], out[key + " passes"], flush=True)
    finally:
        b6._wgrad_splits = picked
    out["B6b splits picked"] = list(own)


def masks(out):
    from weathermodel_tpu_torch.ops import kernel_dropout as kd
    from weathermodel_tpu_torch.ops import maskgen as mg

    m, c, rate = cs.FFN_ROWS, 2304, cs.DROPOUT
    shape = (cs.MICRO, cs.SEQ_LEN, c)
    s1, s2 = cs.MASK_SEEDS
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 9)
    x = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
    xf = x.float()
    for name, fn in (
            ("B9b", lambda: mg.bool_keep_mask(m, c, rate, s2, "cuda")),
            ("B9p", lambda: mg.packed_keep_mask(m, c, rate, s2, "cuda")),
            ("B8m", lambda: kd.random_keep_mask(shape, rate, s1, "cuda")),
            ("B8 bf16", lambda: kd.lane_dropout(x, rate, s1)),
            ("B8 fp32", lambda: kd.lane_dropout(xf, rate, s1))):
        out[f"{name} hash"] = digest(fn())
        out[f"{name} ms"] = cs._cuda_ms(fn, iters=20, warmup=3)
        print(out["tree"], name, out[f"{name} hash"], out[f"{name} ms"],
              flush=True)
    out["keep_mask SASS"] = keep_mask_sass()


# SASS opcodes by the pipe that runs them on Hopper: the FMA pipe (64 lanes
# an SM a clock for IMAD) and the ALU pipe (64 lanes); the rest are memory,
# control, uniform-datapath and other instructions
FMA_OPS = {"IMAD", "FFMA", "FMUL", "FADD", "HFMA2", "HMUL2", "HADD2"}
ALU_OPS = {"LOP3", "SHF", "ISETP", "SEL", "PRMT", "IADD3", "LEA", "P2R",
           "R2P", "MOV", "IABS", "IMNMX", "VIMNMX", "FSEL", "FSETP", "PLOP3",
           "BMSK", "SGXT"}
MEM_OPS = {"LDS", "STS", "LDG", "STG", "LDC", "LDL", "STL", "ATOM", "RED"}
CONTROL_OPS = {"BRA", "EXIT", "BAR", "BSSY", "BSYNC", "NOP", "WARPSYNC",
               "CALL", "RET"}
# the kernels counted: (part of the mangled name, label, [(the store that
# ends an element run, elements it stores)]), the first store the kernel has
# taken; B9p stored one word before its 16-byte store of four (older trees)
SASS_KERNELS = (("bool_mask_kernelILb1E", "B9b", [("STG.E.128", 16)]),
                ("bool_mask_kernelILb0E", "B8m", [("STG.E.128", 16)]),
                ("packed_mask_kernel", "B9p", [("STG.E.128", 128),
                                               ("STG.E", 32)]))


def _pipe(op):
    base = op.split(".")[0]
    for name, ops in (("FMA", FMA_OPS), ("ALU", ALU_OPS), ("memory", MEM_OPS),
                      ("control", CONTROL_OPS)):
        if base in ops:
            return name
    return "uniform" if base.startswith("U") else "other"


def _sass_functions(text):
    """{mangled name: [(address, predicate, opcode, branch target)]}."""
    funcs, cur = {}, None
    for line in text.splitlines():
        head = re.search(r"Function\s*:\s*(\S+)", line)
        if head:
            cur = funcs.setdefault(head.group(1), [])
            continue
        ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if ins and cur is not None:
            body, pred = ins.group(2).strip(), ""
            if body.startswith("@"):
                pred, body = body.split(None, 1)
            op = body.split()[0]
            tgt = (re.search(r"0x([0-9a-f]+)", body)
                   if op.startswith("BRA") else None)
            cur.append((int(ins.group(1), 16), pred, op,
                        int(tgt.group(1), 16) if tgt else None))
    return funcs


def _hot_path(ins, store):
    """The instructions of the shortest path through the first `store`: in
    the innermost loop that holds it, from the loop's head to its back
    branch, else from the entry to an exit. Blocks off that path (the ragged
    edge's byte stores, the early exits) are not counted."""
    at = {a: i for i, (a, _, _, _) in enumerate(ins)}
    lead = {0}
    for i, (_, _, op, tgt) in enumerate(ins):
        if op.startswith("BRA") or op in ("EXIT", "RET"):
            lead.add(i + 1)
            if tgt in at:
                lead.add(at[tgt])
    starts = sorted(x for x in lead if x < len(ins))
    ends = starts[1:] + [len(ins)]
    block = {i: b for b, (s0, e0) in enumerate(zip(starts, ends))
             for i in range(s0, e0)}
    succ = []
    for b, e0 in enumerate(ends):
        _, pred, op, tgt = ins[e0 - 1]
        nxt = [block[e0]] if e0 < len(ins) else []
        if op.startswith("BRA") and tgt in at:
            succ.append([block[at[tgt]]] + (nxt if pred not in ("", "@PT")
                                             else []))
        elif op in ("EXIT", "RET"):
            succ.append(nxt if pred not in ("", "@PT") else [])
        else:
            succ.append(nxt)
    sb = block[next(i for i, x in enumerate(ins) if x[2] == store)]
    size = [e0 - s0 for s0, e0 in zip(starts, ends)]

    def shortest(src, dst, hi):
        dist, prev = {src: size[src]}, {}
        for b in range(src, hi + 1):
            for c in succ[b] if b in dist else ():
                if b < c <= hi and dist[b] + size[c] < dist.get(c, 1 << 30):
                    dist[c], prev[c] = dist[b] + size[c], b
        end = min((b for b in dist if dst(b)), key=dist.get)
        path = [end]
        while path[-1] != src:
            path.append(prev[path[-1]])
        return path[::-1]

    loops = [(h, b) for b in range(len(succ)) for h in succ[b]
             if h <= sb <= b]
    if loops:
        head, back = min(loops, key=lambda hb: hb[1] - hb[0])
        path = (shortest(head, lambda b: b == sb, back)
                + shortest(sb, lambda b: b == back, back)[1:])
    else:
        last = len(succ) - 1
        path = (shortest(0, lambda b: b == sb, last)
                + shortest(sb, lambda b: not succ[b], last)[1:])
    return [x for b in path for x in ins[starts[b]:ends[b]]], bool(loops)


def keep_mask_sass():
    """The cwd tree's csrc/keep_mask.cu built alone for sm_90a, dumped with
    cuobjdump: for B9b, B8m and B9p, the instructions on the hot path per
    element, by pipe, and by opcode."""
    from weathermodel_tpu_torch.kernels import build

    nvcc = build._nvcc()
    cubin = Path("build/sass/keep_mask.cubin")
    cubin.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([nvcc, "-cubin", *build.NVCC_FLAGS[:4], "-o", str(cubin),
                    "weathermodel_tpu_torch/csrc/keep_mask.cu"], check=True,
                   capture_output=True)
    dump = subprocess.run(
        [str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
        check=True, capture_output=True, text=True).stdout
    funcs = _sass_functions(dump)
    got = {}
    for kernel, label, stores in SASS_KERNELS:
        ins = next(ins for f, ins in funcs.items() if kernel in f)
        store, per_store = next((op, n) for op, n in stores
                                if any(x[2] == op for x in ins))
        path, looped = _hot_path(ins, store)
        elems = per_store * sum(op == store for _, _, op, _ in path)
        pipes = Counter(_pipe(op) for _, _, op, _ in path)
        got[label] = {
            "elements": elems, "loop": looped,
            "per element": round(len(path) / elems, 4),
            "by pipe": {k: round(v / elems, 4) for k, v in sorted(
                pipes.items())},
            "by opcode": dict(Counter(op for _, _, op, _ in path)
                              .most_common())}
        print(sys.argv[1], "SASS", label, json.dumps(got[label]), flush=True)
    return got


def _maskgen_split(cfg):
    """One profiled step (after a warm-up step) of the bench's `torch` FFN
    under set_impl("maskgen"): device ms and kernels of the whole step, of
    B9p, and of the elementwise kernels that unpack its words (`unpack_keep`)
    and apply them (`apply_keep`), forward and backward, each read from the
    kernels launched inside a `record_function` range put around the call
    for this step only."""
    from torch.autograd import DeviceType

    from weathermodel_tpu_torch.ops import maskgen as mg
    from weathermodel_tpu_torch.train.steps import batch_to_device

    def ranged(label, fn):
        def call(*args):
            with torch.profiler.record_function(label):
                return fn(*args)
        return call

    _, step = cs._train_step_fn("weatherbert", cfg, "fused_qkv", "cuda",
                                cs.GRAD_ACCUM)
    batch = batch_to_device(cs._windows_batch(cs.TRAIN_BATCH, cs.SEED)[0],
                            "cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    float(step(batch, gen, 1e-4, 10)["total_loss"])  # warm-up
    torch.cuda.synchronize()
    labels = ("maskgen unpack", "maskgen apply")
    saved = mg.unpack_keep, mg.apply_keep
    mg.unpack_keep, mg.apply_keep = (ranged(*a) for a in zip(labels, saved))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            float(step(batch, gen, 1e-4, 10)["total_loss"])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        mg.unpack_keep, mg.apply_keep = saved

    def launched(e):
        return len(e.kernels) + sum(launched(c) for c in e.cpu_children)

    # the ranges' device-side spans are no kernels
    kernels = [e for e in cs._kernel_events(prof) if e.key not in labels]
    got = {"wall ms": wall_ms,
           "device ms": sum(cs._device_ms(e) for e in kernels),
           "kernels": sum(e.count for e in kernels)}
    b9p = [e for e in kernels if "packed_mask_kernel" in e.key]
    got["B9p ms"] = sum(cs._device_ms(e) for e in b9p)
    got["B9p kernels"] = sum(e.count for e in b9p)
    for label in labels:
        ranges = [e for e in prof.events() if e.name == label
                  and e.device_type == DeviceType.CPU]
        got[label + " calls"] = len(ranges)
        got[label + " ms"] = sum(e.device_time_total for e in ranges) / 1e3
        got[label + " kernels"] = sum(launched(e) for e in ranges)
    return got


def maskgen_bench(out):
    """The bench's `torch` FFN under set_impl("maskgen") (B9p) and
    ("maskgen_bool") (B9b): samples/s, and for each one profiled step (B9p's
    split by `_maskgen_split`, B9b's device time by kernel name)."""
    from weathermodel_tpu_torch.ops import dropout
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(cs.MODEL_SIZE, compute_dtype="bfloat16")
    try:
        dropout.set_impl("maskgen")
        out["bench torch maskgen"] = cs._bench(
            {"BENCH_FFN_IMPL": "torch"}, cs._all_kernels())[0]["value"]
        out["bench torch maskgen split"] = _maskgen_split(cfg)
        print(out["tree"], out["bench torch maskgen"],
              out["bench torch maskgen split"], flush=True)
        dropout.set_impl("maskgen_bool")
        out["bench torch maskgen_bool"] = cs._bench(
            {"BENCH_FFN_IMPL": "torch"}, cs._all_kernels())[0]["value"]
        out["bench torch maskgen_bool profile"] = cs._profile_step(
            "weatherbert", cfg, "fused_qkv", cs.TRAIN_BATCH, cs.GRAD_ACCUM,
            named=(("B9b", "bool_mask_kernel"),))
    finally:
        dropout.set_impl("auto")
    print(out["tree"], out["bench torch maskgen_bool"],
          out["bench torch maskgen_bool profile"], flush=True)


def bench(out):
    counted = cs._all_kernels()
    for name, env in (
            ("bench torch", {"BENCH_FFN_IMPL": "torch"}),
            ("bench fused_ffn_ln", {"BENCH_FFN_IMPL": "fused_ffn_ln"}),
            ("bench fused_ffn", {"BENCH_FFN_IMPL": "fused_ffn"}),
            ("bench fused_qkv_op eval", {"BENCH_ATTENTION": "fused_qkv_op",
                                         "BENCH_MODE": "eval"})):
        out[name] = cs._bench(env, counted)[0]["value"]
        print(out["tree"], name, out[name], flush=True)


def training(out):
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    large = dict(compute_dtype="bfloat16")
    runs = (
        ("train", model_config_for_size("large", **large), cs.TRAIN_BATCH,
         1, ["--model", "weatherbert", "--model-size", "large",
             "--grad-accum", str(cs.GRAD_ACCUM), "--masking-prob", "0.15"]),
        ("train_moe", model_config_for_size("large", **large, **cs.MOE),
         cs.MOE_BATCH, 1, ["--model", "weatherbert", "--model-size", "large",
                           "--moe-experts", "8", "--moe-top-k", "2",
                           "--grad-accum", str(cs.MOE_ACCUM),
                           "--masking-prob", "0.15"]),
        ("train_former", model_config_for_size("small", **large),
         cs.FORMER_BATCH, 2, ["--model", "weatherformer", "--model-size",
                              "small", "--n-masked-features", "10",
                              "--beta", "0.5"]))
    counted = cs._all_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        data = cs._write_store(Path(tmp))
        for name, cfg, batch, heads, argv in runs:
            with tempfile.TemporaryDirectory() as workdir:
                result = cs._run_pretrain(argv + [
                    "--batch-size", str(batch), "--n-epochs", "2",
                    "--n-warmup-epochs", "0", "--data-dir", str(data),
                    "--workdir", workdir, "--compute-dtype", "bfloat16",
                    "--device", "cuda"], counted)[0]
            out[name] = cs._throughput(result, cfg, batch,
                                       heads * cfg.output_dim)[1]
            print(out["tree"], name, out[name], flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": sys.argv[1]}
    if "--attention" in sys.argv[2:]:
        attention(out)
        yield_step(out)
        print("RESULT " + json.dumps(out), flush=True)
        return
    if "--masks" in sys.argv[2:]:
        masks(out)
        print("RESULT " + json.dumps(out), flush=True)
        return
    grouped_matmul(out)
    torch.cuda.empty_cache()
    kernels(out)
    torch.cuda.empty_cache()
    probes_and_attention(out)
    torch.cuda.empty_cache()
    masks(out)
    torch.cuda.empty_cache()
    if "--splits" in sys.argv[2:]:
        splits(out)
        torch.cuda.empty_cache()
    bench(out)
    maskgen_bench(out)
    training(out)
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
