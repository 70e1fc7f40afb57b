"""Time and trace one batched cadenced chunk of the fleet path on the
current device, and print where the device time goes.

Prints the cold compile seconds of the chunk step, the warm chunk time of
each repetition, then traces one warm chunk with jax.profiler and reduces
the trace to device time per op kind, per top op, and per named scope
(the jax.named_scope names in ops/klt.py, e.g. klt_extract_L0 and
klt_lk_L0). Device time counts only events on the device planes of the
trace. The trace directory also keeps the chunk step's compiled HLO
(chunk_step.hlo.txt), which maps kernels to scopes. The last stdout line
is one JSON object with those numbers.

XLA launches most kernels of the step from command buffers (CUDA graphs);
a library kernel (cuBLAS) launched from one carries no HLO op and counts
as unmapped. For a full attribution, trace with command buffers off
(XLA_FLAGS=--xla_gpu_enable_command_buffer=); kernel times are the same,
the chunk's wall time is not.

    python scripts/profile_chunk.py --streams 8 --chunk 12 --cadence 6
    python scripts/profile_chunk.py --cpu --small --streams 2   # rehearsal
    python scripts/profile_chunk.py --reduce out/trace   # re-reduce a trace
"""

import argparse
import collections
import glob
import json
import os
import re
import shutil
import sys
import time

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
HLO_FILE = "chunk_step.hlo.txt"
SCOPES = ("klt_extract_L", "klt_lk_L")  # named-scope prefixes reported
T0 = time.perf_counter()


def log(m):
    print(f"[+{time.perf_counter() - T0:6.1f}s] {m}", file=sys.stderr, flush=True)


def _norm(name: str) -> str:
    """HLO instruction names as kernel names spell them ('.' and '-' -> '_')."""
    return re.sub(r"[.\-]", "_", name)


def hlo_scopes(hlo_text: str) -> dict:
    """Normalized instruction name -> its op_name metadata, prefixed by the
    op_names of the instructions that call its computation (outermost
    first, joined by ' > '). The caller chain matters: XLA shares one loop
    body between loops of identical shape (the LK loops of several pyramid
    levels), so the body keeps the metadata of one level while each while
    instruction keeps its own. An instruction without metadata of its own
    (a fusion, a library call) takes its called computation's root
    op_name."""
    op_name, calls, root_of, comp_of, caller = {}, {}, {}, {}, {}
    comp = None
    for line in hlo_text.splitlines():
        m = re.match(r"^(?:ENTRY )?%(\S+) .*\{$", line)
        if m:
            comp = m.group(1)
            continue
        m = re.match(r"^\s*(ROOT )?%(\S+) = ", line)
        if not m:
            continue
        name = m.group(2)
        comp_of[name] = comp
        md = re.search(r'op_name="([^"]*)"', line)
        if md:
            op_name[name] = md.group(1)
        c = re.search(r"calls=%([\w.\-]+)", line)
        if c:
            calls[name] = c.group(1)
        for callee in re.findall(
                r"(?:calls|body|condition|to_apply)=%([\w.\-]+)", line):
            caller[callee] = name
        if m.group(1) and comp:
            root_of[comp] = name

    def own(name, depth=0):
        if name in op_name or depth > 8:
            return op_name.get(name, "")
        if name in calls and calls[name] in root_of:
            return own(root_of[calls[name]], depth + 1)
        return ""

    def chain(name):
        names, seen = [], set()
        while name and name not in seen:
            seen.add(name)
            names.append(own(name))
            name = caller.get(comp_of.get(name))
        return " > ".join(n for n in reversed(names) if n)

    return {_norm(n): chain(n) for n in comp_of}


def device_events(trace_dir: str, host_ops: bool):
    """(name, hlo_op, duration_ns) of every event on a device plane; with
    host_ops (a CPU rehearsal), of every XLA op event on the host plane."""
    from jax.profiler import ProfileData

    paths = glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True)
    if not paths:
        raise RuntimeError(f"no .xplane.pb under {trace_dir}")
    out = []
    for plane in ProfileData.from_file(paths[0]).planes:
        on_device = plane.name.startswith("/device:")
        if not (on_device or (host_ops and plane.name.startswith("/host:"))):
            continue
        for line in plane.lines:
            # module-level and step lines duplicate the kernels below them
            if line.name in ("XLA Modules", "Steps", "XLA TraceMe"):
                continue
            for e in line.events:
                stats = dict(e.stats)
                if on_device or "hlo_op" in stats:
                    out.append(
                        (e.name, str(stats.get("hlo_op", "")), e.duration_ns))
    return out


def reduce_trace(trace_dir: str, scopes, top: int, host_ops: bool) -> dict:
    """Print the device-time breakdown of a trace directory; return the
    totals. A kernel maps to an HLO instruction by its own name, else by
    its hlo_op stat."""
    with open(os.path.join(trace_dir, HLO_FILE)) as f:
        scope_of = hlo_scopes(f.read())
    events = device_events(trace_dir, host_ops)
    total = sum(ev[2] for ev in events)
    by_kind, by_name, cnt = (collections.Counter() for _ in range(3))
    by_scope = collections.Counter()
    unmatched = 0
    for name, hlo_op, d in events:
        by_name[name] += d
        kind = re.split(r"[._]\d", name)[0]
        by_kind[kind] += d
        cnt[kind] += 1
        op = scope_of.get(_norm(name)) or scope_of.get(_norm(hlo_op), "")
        if not op:
            unmatched += d
        for p in scopes:
            m = re.search(rf"(?:^|/)({re.escape(p)}\w*)(?:/|$| )", op)
            if m:
                by_scope[m.group(1)] += d
                break

    print(f"device time in one chunk: {total / 1e6:.3f} ms over {len(events)} "
          f"events ({unmatched / 1e6:.3f} ms not mapped to an HLO op)")
    print("-- by op kind --")
    for n, d in by_kind.most_common(15):
        print(f"  {d / 1e6:9.3f} ms x{cnt[n]:6d}  {n[:100]}")
    print("-- top ops --")
    for n, d in by_name.most_common(top):
        print(f"  {d / 1e6:9.3f} ms  {n[:100]}")
    print("-- named scopes --")
    for n in sorted(by_scope):
        print(f"  {by_scope[n] / 1e6:9.3f} ms  {n}")
    return {
        "trace_device_ms": total / 1e6,
        "unmapped_device_ms": unmatched / 1e6,
        "scope_device_ms": {k: v / 1e6 for k, v in sorted(by_scope.items())},
    }


def profile(args) -> dict:
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    _ = jax.devices()
    import numpy as np

    sys.path.insert(0, REPO)
    from svo_tpu.config import Config
    from svo_tpu.geometry import camera as cam_mod
    from svo_tpu.io.synthetic import SyntheticSequence
    from svo_tpu.parallel.batched import BatchedStereoVO

    shape = (184, 320) if args.small else (376, 1241)
    fx = 200.0 if args.small else 718.856
    n_frames = 1 + args.chunk
    seq = SyntheticSequence(n_frames=n_frames, shape=shape, fx=fx)
    frames = list(seq)
    log(f"{n_frames} frames rendered")

    cfg = Config(use_orb=False, image_height=shape[0], image_width=shape[1])
    camera = cam_mod.from_intrinsics(
        seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline
    )
    S, CH = args.streams, args.chunk
    streams = [frames if s % 2 == 0 else frames[::-1] for s in range(S)]
    l0 = np.stack([st[0][1] for st in streams])
    r0 = np.stack([st[0][2] for st in streams])

    def u8(x):
        return np.clip(x, 0, 255).astype(np.uint8)

    ts = range(1, 1 + CH)
    lefts = jax.device_put(
        np.stack([np.stack([u8(st[t][1]) for st in streams]) for t in ts]))
    rights = jax.device_put(
        np.stack([np.stack([u8(st[t][2]) for st in streams]) for t in ts]))
    jax.block_until_ready((lefts, rights))

    bvo = BatchedStereoVO(cfg, camera, S, chunk=CH, kf_cadence=args.cadence)
    bvo.start(l0, r0)
    jax.block_until_ready(bvo.state.pose)
    t0 = time.perf_counter()
    bvo.process_chunk(lefts, rights)
    jax.block_until_ready(bvo.state.pose)
    compile_s = time.perf_counter() - t0
    log(f"first chunk (compile + run): {compile_s:.2f} s")

    warm_ms = []
    for _ in range(args.reps):
        bvo.start(l0, r0)
        jax.block_until_ready(bvo.state.pose)
        t0 = time.perf_counter()
        bvo.process_chunk(lefts, rights)
        jax.block_until_ready(bvo.state.pose)
        warm_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"warm chunk ms: {warm_ms}")

    hlo = bvo._chunk_step.lower(bvo.state, lefts, rights).compile().as_text()
    bvo.start(l0, r0)
    jax.block_until_ready(bvo.state.pose)
    shutil.rmtree(args.trace_dir, ignore_errors=True)
    with jax.profiler.trace(args.trace_dir):
        bvo.process_chunk(lefts, rights)
        jax.block_until_ready(bvo.state.pose)
    with open(os.path.join(args.trace_dir, HLO_FILE), "w") as f:
        f.write(hlo)
    print(f"device: {jax.devices()[0].device_kind}, {S} streams, chunk {CH}")
    return {
        "device_kind": jax.devices()[0].device_kind,
        "streams": S, "chunk": CH, "cadence": args.cadence,
        "shape": list(shape),
        "compile_plus_first_chunk_s": compile_s,
        "warm_chunk_ms": warm_ms,
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--reduce", metavar="TRACE_DIR",
                        help="only reduce an existing trace directory")
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--small", action="store_true",
                        help="184x320 frames instead of KITTI's 376x1241")
    parser.add_argument("--streams", type=int, default=8)
    parser.add_argument("--chunk", type=int, default=12)
    parser.add_argument("--cadence", type=int, default=6)
    parser.add_argument("--reps", type=int, default=3, help="warm timed chunks")
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--trace-dir",
                        default=os.path.join(REPO, "out", "trace"))
    args = parser.parse_args()
    if args.reduce:
        out = reduce_trace(args.reduce, SCOPES, args.top, host_ops=args.cpu)
    else:
        out = profile(args)
        out.update(reduce_trace(args.trace_dir, SCOPES, args.top, args.cpu))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
