"""What holds a step of psi's cluster-layout forward and adjoint chain.

It times the streamed training forward (``csrc/psi_cluster_fwd.cu``, kStream)
and the adjoint (``csrc/psi_cluster_bwd.cu``: the tail, then the chain; the
chain is the adjoint's time less the tail's) at D=128, B=128 (4 CTAs a
cluster, 4 columns a cluster: 32 clusters) and at D=256, B=16 (16 CTAs, 2
columns: 8 clusters), each as built and as variants of the same sources
with parts of a step taken out:

  built     the kernels the training path runs
  walk      the walk alone: no push of the state or the atoms' sums, no
            exchange (no wait, no cluster barrier)
  exchange  the pushes and the exchange, no walk (a walk's outputs read
            from the state buffer)
  atoms     no walk and no push of the state: the exchange of the atoms'
            sums alone, with whatever orders a step in the sources (a
            cluster barrier a step, or the receivers' mbarriers), so the
            column reads the same work in any checkout
  notake    the whole step without the loss lanes' (the forward) or the ds
            lanes' (the chain) sums of the atoms

each at the deferred norm (a renorm step every 16th) and the per-step norm
(every step), at highest; and the adjoint's tail, where the sources hold
the tiled product of S (``psi_cl_tail_kernel``'s y tile and slab ring;
skipped in sources without it), split as

  tail_noy    the tail without its global loads of the tile's y (the
              shared-memory stores of a constant in their place)
  tail_nomul  the tail without its products (the y loads, S's slabs in
              flight and the epilogue kept)
  tail_nos    the tail without its copies of S's slabs (the products read
              whatever the stages hold)

The variants' outputs are not used. Each variant is built with nvcc from
a copy of ``csrc/`` patched in memory (``--root`` names the checkout whose
sources are copied, so one run can split the parent's step and another
this tree's); a patch raises when the sources no longer hold what it
replaces. CUDA events, the median of 3 runs after a warm-up; it prints ms
and us a step of each, the card's name and power limit, and the tail
beside ``torch.matmul`` of its product(s). It needs an NVIDIA card and the
CUDA toolkit.

    python -m audio_mps_tpu_torch.tools.psi_cluster_attribution \\
        [--root=build/parent] [--steps=4096] [--variants=built,tail_noy]
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from ..config import CMPSConfig
from ..data import damped_sine_batch
from ..models.params import init_psi
from ..ops import _build, block, cluster

SHAPES = ((128, 128), (256, 16))   # (D, B); C and G: the layout's rule
SOURCES = ("psi_cluster_fwd.cu", "psi_cluster_bwd.cu")
ENTRIES = ("amt_psi_cl_train_fwd", "amt_psi_cl_tail", "amt_psi_cl_train_bwd")

# A stub replaces a device function's body by its text (the function found
# by name in the headers); every name listed must be found at least once,
# unless it is marked optional by a leading "?".
_WALK_OUT = ("for (int m_ = 0; m_ < NM; ++m_)\n"
             "    for (int c_ = 0; c_ < G; ++c_) out[m_][c_] = vh[c_];\n"
             "  return;")
_NO_PUSH = {"cl_push_vec": "return;", "cl_push_atoms": "return;"}
_NO_SYNC = {"cluster_sync": "return;", "?cluster_arrive": "return;",
            "?cluster_wait": "return;", "?cl_exchange_done": "return;",
            "?cl_exchange_wait": "return;"}
_NO_STATE = {"cl_push_vec": "return;", "?cl_vec_bytes": "return 0u;"}
_NO_TAKE = {"?cl_take_loss": "return;"}
# Text edits for the takes that are lambdas in a kernel's body: (old, new)
# pairs of which at least one must match exactly once.
_TAKE_EDITS = (("    if (!lossl) return;\n    const float n2 = cl_total",
                "    return;\n    const float n2 = cl_total"),
               ("    if (pend >= 0 && lossl && live[lc]) {",
                "    if (false) {"),
               ("    if (rdy >= 0 && lossl && live[lc])\n      dse[",
                "    if (false)\n      dse["))
# Text edits of the tiled tail (psi_cluster_bwd.cu psi_cl_tail_kernel)
_TAIL_NO_Y = (("""          if (j < n && off >= 0)
            y = __ldg(ys + off + static_cast<size_t>(j) * B);""",
               """          if (j < n && off >= 0)
            y = 1.f;"""),)
_TAIL_NO_MUL = (("""      __syncthreads();
      if (comp) {
        const uint32_t* sw = ss + stage * KS * np + 4 * tm;""",
                 """      __syncthreads();
      if (false) {
        const uint32_t* sw = ss + stage * KS * np + 4 * tm;"""),)
_TAIL_NO_S = (("    for (int idx = tid; idx < KS * c4; idx += blockDim.x) {",
               "    for (int idx = tid; idx < 0; idx += blockDim.x) {"),)
VARIANTS = {
    "built": ({}, ()),
    "walk": ({**_NO_PUSH, **_NO_SYNC}, ()),
    "exchange": ({"cl_walk": _WALK_OUT}, ()),
    "atoms": ({"cl_walk": _WALK_OUT, **_NO_STATE}, ()),
    "notake": (_NO_TAKE, _TAKE_EDITS),
    "tail_noy": ({}, _TAIL_NO_Y),
    "tail_nomul": ({}, _TAIL_NO_MUL),
    "tail_nos": ({}, _TAIL_NO_S),
}
# built only where the sources hold what they edit
OPTIONAL = ("tail_noy", "tail_nomul", "tail_nos")


def _stub(text: str, name: str, body: str) -> tuple:
    """text with the body of every device function ``name`` replaced by
    ``body``, and how many it replaced."""
    count = 0
    out = []
    pos = 0
    pat = re.compile(r"__device__[^;{]*?\b" + re.escape(name) + r"\(")
    for m in pat.finditer(text):
        start = text.index("{", m.end())
        depth, i = 0, start
        while True:
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
                if depth == 0:
                    break
            i += 1
        out.append(text[pos:start + 1] + "\n  " + body + "\n")
        pos = i
        count += 1
    out.append(text[pos:])
    return "".join(out), count


def patch_sources(src: Path, variant: str):
    """Apply ``variant``'s stubs and edits to the copy of csrc/ at src."""
    stubs, edits = VARIANTS[variant]
    files = sorted(src.glob("*.cuh")) + [src / s for s in SOURCES]
    texts = {f: f.read_text() for f in files}
    for name, body in stubs.items():
        optional = name.startswith("?")
        name = name.lstrip("?")
        found = 0
        for f in files:
            texts[f], c = _stub(texts[f], name, body)
            found += c
        if not found and not optional:
            raise RuntimeError(f"variant {variant}: no device function "
                               f"{name} in {src}")
    if edits:
        hits = 0
        for old, new in edits:
            for f in files:
                if texts[f].count(old) == 1:
                    texts[f] = texts[f].replace(old, new)
                    hits += 1
        if not hits:
            raise RuntimeError(f"variant {variant}: none of its edits "
                               f"matches the sources in {src}")
    for f, t in texts.items():
        f.write_text(t)


def build_variants(root: Path, which=tuple(VARIANTS)) -> dict:
    """{variant: the loaded library}, each compiled from root's csrc/ (the
    two cluster sources, one nvcc a source, all started together); an
    ``OPTIONAL`` variant whose edits root's sources do not hold is left
    out."""
    out = _build.ROOT / "build" / "attribution" / "psi_cluster"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = []
    names = []
    for name in which:
        src = out / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(root / "audio_mps_tpu_torch" / "csrc", src)
        try:
            patch_sources(src, name)
        except RuntimeError:
            if name not in OPTIONAL:
                raise
            print(f"variant {name}: not in these sources, left out",
                  flush=True)
            continue
        names.append(name)
        for s in SOURCES:
            obj = src / (s + ".o")
            procs.append((name, obj, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(obj),
                 str(src / s)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for name, obj, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
    libs = {}
    for name in names:
        lib = out / f"lib_{name}.so"
        subprocess.run([nvcc, "-shared", "-o", str(lib),
                        *[str(out / name / (s + ".o")) for s in SOURCES]],
                       check=True, capture_output=True)
        libs[name] = ctypes.CDLL(str(lib))
        for entry in ENTRIES:
            fn = getattr(libs[name], entry)
            fn.argtypes, fn.restype = _build._SIGNATURES[entry]
    return libs


def median_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def shape_inputs(dev, D: int, B: int, steps: int) -> dict:
    """The kernels' inputs at D, B over ``steps`` steps (seeded)."""
    cfg = CMPSConfig(bond_dim=D, minibatch_size=B)
    params = init_psi(torch.Generator(dev).manual_seed(70), cfg, device=dev)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(71), B,
                            steps + 1, cfg.delta_t)
    return block.psi_nll_inputs(params, cfg, sig)


def _rule(dev, D: int, B: int) -> tuple:
    props = torch.cuda.get_device_properties(dev)
    return cluster.psi_block_layout(D, B, props.multi_processor_count,
                                    props.shared_memory_per_block_optin)[1:]


def fwd_inputs(dev, D: int = 128, B: int = 128, steps: int = 4096,
               defer_norm: bool = True, precision: str = "highest") -> dict:
    """Keyword arguments of ``ops.cluster``'s forward wrappers at D, B (the
    rule's cluster and columns), for ``tools/checkout_timer.py``."""
    C, G = _rule(dev, D, B)
    return dict(shape_inputs(dev, D, B, steps), unroll=16,
                precision=precision, defer_norm=defer_norm, cluster=C,
                cols=G)


def recompute_inputs(dev, **kw) -> dict:
    """``psi_recompute_cluster``'s arguments: the checkpoints of this
    checkout's checkpoint forward on ``fwd_inputs``."""
    ins = fwd_inputs(dev, **kw)
    _, ck = cluster.psi_train_fwd_ckpt_cluster(**ins)
    ins.pop("t0")
    ins.pop("log_eps")
    return dict(ins, ck=ck)


def bwd_inputs(dev, **kw) -> dict:
    """``psi_train_bwd_cluster``'s arguments: ``fwd_inputs``, g = 1 / B and
    the streams of this checkout's forward."""
    ins = fwd_inputs(dev, **kw)
    _, ys, n2s = cluster.psi_train_fwd_cluster(**ins)
    B = ins["se"].shape[1]
    return dict(ins, g=torch.full((B,), 1.0 / B, device=dev), ys=ys,
                n2s=n2s)


def time_shape(libs: dict, dev, D: int, B: int, steps: int):
    C, G = _rule(dev, D, B)
    ins = shape_inputs(dev, D, B, steps)
    ab, bb, rb, t0, se = (ins[k] for k in ("ab", "bb", "rb", "t0", "se"))
    le, ne = ins["log_eps"], ins["norm_eps"]
    n = 2 * D
    loss = se.new_empty((B,))
    ys = se.new_empty((steps, n, B))
    n2s = se.new_empty((steps, B))
    dse, deh, dn2 = (torch.empty_like(se) for _ in range(3))
    dys = torch.empty_like(ys)
    dt0 = torch.empty_like(t0)
    g = torch.full((B,), 1.0 / B, device=dev)
    rbp = se.new_empty((2 * n * n,))
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = [x.data_ptr() for x in (ab, bb, rb, t0, se, loss, ys, n2s)]

    def go(lib, entry, *a):
        err = getattr(lib, entry)(*a)
        if err:
            raise RuntimeError(f"{entry}: CUDA error {err}")

    def fwd(lib, defer):
        go(lib, "amt_psi_cl_train_fwd", *p, D, steps, B, 16, le, ne, 0,
           int(defer), C, G, stream)

    def tail(lib, defer):
        go(lib, "amt_psi_cl_tail", rb.data_ptr(), rbp.data_ptr(),
           se.data_ptr(), g.data_ptr(), ys.data_ptr(), n2s.data_ptr(),
           dse.data_ptr(), dys.data_ptr(), deh.data_ptr(), dn2.data_ptr(),
           D, steps, B, 16, le, ne, 0, int(defer), stream)

    def bwd(lib, defer):
        go(lib, "amt_psi_cl_train_bwd", ab.data_ptr(), bb.data_ptr(),
           rb.data_ptr(), t0.data_ptr(), se.data_ptr(), g.data_ptr(),
           ys.data_ptr(), n2s.data_ptr(), None, dse.data_ptr(),
           dt0.data_ptr(), dys.data_ptr(), deh.data_ptr(), dn2.data_ptr(),
           rbp.data_ptr(), D, steps, B, 16, le, ne, 0, int(defer), C, G,
           stream)

    print(f"psi at D={D}, B={B}: {C} CTAs a cluster, {G} columns a cluster "
          f"({-(-B // G)} clusters), {steps} steps, highest; median of 3 "
          f"CUDA-event runs", flush=True)
    for defer in (True, False):
        # the built forward writes the ys and n2s the adjoints read
        fwd(libs["built"], defer)
        torch.cuda.synchronize()
        for name, lib in libs.items():
            if name.startswith("tail_"):
                t_ms = median_ms(lambda: tail(lib, defer))
                print(f"  defer_norm={defer} {name:10s}: tail {t_ms:7.3f} "
                      f"ms", flush=True)
                continue
            f_ms = median_ms(lambda: fwd(lib, defer))
            if name != "built":   # the variants' ys are not a forward's
                fwd(libs["built"], defer)
            t_ms = median_ms(lambda: tail(lib, defer))
            b_ms = median_ms(lambda: bwd(lib, defer))
            c_ms = b_ms - t_ms
            print(f"  defer_norm={defer} {name:8s}: fwd {f_ms:8.3f} ms "
                  f"({f_ms / steps * 1e3:6.3f} us/step); adjoint "
                  f"{b_ms:8.3f} ms = tail {t_ms:7.3f} + chain {c_ms:8.3f} "
                  f"({c_ms / steps * 1e3:6.3f} us/step)", flush=True)
    s_mat = rb + rb.t()
    lanes = ys.transpose(0, 1).reshape(n, -1)
    one = median_ms(lambda: s_mat @ lanes)
    two = median_ms(lambda: (rb @ lanes, rb.t().contiguous() @ lanes))
    print(f"  the tail's yardsticks at {steps * B} lanes: torch.matmul(S, Y) "
          f"{one:.3f} ms, torch.matmul x2 (Rb Y, Rb^T U) {two:.3f} ms",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(_build.ROOT),
                    help="the checkout whose csrc/ the variants patch")
    ap.add_argument("--steps", type=int, default=4096)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants to build and time")
    args = ap.parse_args(argv)
    which = args.variants.split(",")
    unknown = [v for v in which if v not in VARIANTS]
    if unknown or "built" not in which:
        ap.error(f"--variants: {unknown or 'built'} (known: "
                 f"{', '.join(VARIANTS)}; built is needed)")
    if not torch.cuda.is_available():
        print("psi_cluster_attribution: needs an NVIDIA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    root = Path(args.root).resolve()
    libs = build_variants(root, which)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}; sources of {root}", flush=True)
    for D, B in SHAPES:
        time_shape(libs, dev, D, B, args.steps)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
