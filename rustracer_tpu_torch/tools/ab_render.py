"""Camera rays/s of two or more checkouts of the port on one card, in
turns, and of the per-render counters on and off within a checkout: for a
change to the main path whose cost is a few per cent, below the spread
between two runs of one render.

  python -m rustracer_tpu_torch.tools.ab_render --tree parent=DIR \\
      --tree change=. [--scene dragon --scene testball-matte] \\
      [--rounds 6] [--samples 4] [--out FILE] [--res 1024] [--cpu]
      [--count-ops]

Each tree runs in a worker process of its own, which imports the package
from that tree, builds each scene once and renders it when asked. A tree
whose ``RenderConfig`` has ``collect_stats`` gives two variants, the
counters on ("NAME+stats", its default) and off ("NAME-stats"); an older
tree gives one ("NAME"). The scenes: ``dragon``, the textured headline
dragon (``scenes.build_dragon``, 1024^2, samples [0, --samples) of its
64-spp config, depth 5, 2^18-lane tiles, compaction on), and
``testball-<name>``, scenes/testball-<name>.pbrt at 1024^2 through
``parse_scene_string``. Each renders through its integrator's ``li`` in a
``Renderer`` as chip_smoke's phases 6 and 16 do.

After one warm-up render of every variant, each round renders every
variant once, in an order turned by one each round and reversed every
other round. Printed: each render's camera rays/s, and per variant their
mean and median, and the median host CPU seconds of the render's thread
(``time.thread_time``: the host's work, which the wall time holds beside
the waits of a shared host), beside the card's name and power limit
(nvidia-smi);
``--out`` writes the same as JSON. ``--count-ops`` prints instead each
variant's PyTorch operator calls a step (every aten op dispatched in a
1-sample render after one uncounted render, over its steps): the host work a variant adds, the same
count on the CPU as on the card apart from the kernels' plain versions,
which the CPU runs in their place.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

LANES = 1 << 18


def _scene(name, res, dev):
    """-> (ctx, camera, film, sampler, li) of scene ``name`` at ``res``
    on ``dev``."""
    if name == "dragon":
        from rustracer_tpu_torch.scenes import build_dragon
        ctx, cam, film, sampler, integ, _ = build_dragon(res=res, device=dev)
        return ctx, cam, film, sampler, integ.li
    from rustracer_tpu_torch.scene.api import parse_scene_string
    from rustracer_tpu_torch.tools.profile_step import testball_text
    from rustracer_tpu_torch.utils import fileutil
    text, scenes = testball_text(name, res)
    fileutil.set_search_directory(scenes)
    b = parse_scene_string(text, device=dev).scene
    return b.context(), b.camera, b.film, b.sampler, b.integrator.li


class _CountOps:
    """A dispatch mode counting the aten operator calls under it."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(mode, func, types, args=(), kwargs=None):
                self.n += 1
                return func(*args, **(kwargs or {}))
        self.n, self.mode = 0, Mode()


def worker(tree, res, dev):
    """Serve render requests, one JSON line each on stdin, with the
    package of ``tree`` on ``dev``: {"scene", "stats" (true, false or
    null: the tree's default), "samples", "count_ops"} -> {"secs",
    "thread_secs", "rays", "ops_a_step"}."""
    sys.path.insert(0, os.path.abspath(tree))
    import dataclasses
    import torch
    from rustracer_tpu_torch.render.renderer import RenderConfig, Renderer
    has_stats = "collect_stats" in {
        f.name for f in dataclasses.fields(RenderConfig)}
    print(json.dumps({"has_stats": has_stats}), flush=True)
    scenes = {}
    for line in sys.stdin:
        req = json.loads(line)
        if req.get("quit"):
            break
        if req["scene"] not in scenes:
            scenes[req["scene"]] = _scene(req["scene"], res, dev)
        ctx, cam, film, sampler, li = scenes[req["scene"]]
        kw = {} if req["stats"] is None else {"collect_stats": req["stats"]}
        r = Renderer(li, cam, film, sampler,
                     RenderConfig(max_lanes=LANES, **kw), device=dev)
        sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
        count = _CountOps() if req.get("count_ops") else None
        sync()
        t0, c0 = time.perf_counter(), time.thread_time()
        if count:
            with count.mode:
                r.render_state(ctx, sample_stop=req["samples"])
        else:
            r.render_state(ctx, sample_stop=req["samples"])
        sync()
        secs, csecs = time.perf_counter() - t0, time.thread_time() - c0
        print(json.dumps({
            "secs": secs, "thread_secs": csecs,
            "rays": res[0] * res[1] * req["samples"],
            "ops_a_step": count and count.n / (len(r.tiles)
                                               * req["samples"])}),
            flush=True)


class _Worker:
    def __init__(self, name, tree, res, dev):
        tree = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH="")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--res", str(res[0]), "--device", dev],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=tree, env=env)
        self.name = name
        self.has_stats = self._read()["has_stats"]

    def _read(self):
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"worker {self.name} ended "
                               f"(rc {self.proc.wait()})")
        return json.loads(line)

    def render(self, scene, stats, samples, count_ops=False):
        self.proc.stdin.write(json.dumps(dict(
            scene=scene, stats=stats, samples=samples,
            count_ops=count_ops)) + "\n")
        self.proc.stdin.flush()
        return self._read()

    def close(self):
        if self.proc.poll() is None:
            self.proc.stdin.write(json.dumps({"quit": True}) + "\n")
            self.proc.stdin.flush()
            self.proc.wait(timeout=60)


def card(dev):
    if dev != "cuda":
        return "the CPU"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def order(variants, r):
    """Round ``r``'s order: turned by r, reversed on odd rounds."""
    k = r % len(variants)
    v = variants[k:] + variants[:k]
    return v[::-1] if r % 2 else v


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR, a checkout of the repo (one or more)")
    ap.add_argument("--scene", action="append", default=None)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--res", type=int, default=1024,
                    help="the film's width and height")
    ap.add_argument("--cpu", action="store_true",
                    help="on the CPU, at a small --res (a check of the tool)")
    ap.add_argument("--count-ops", action="store_true",
                    help="print each variant's operator calls a step")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    res = (a.res, a.res)
    if a.worker:
        return worker(a.worker, res, a.device)
    if not a.tree:
        ap.error("give at least one --tree NAME=DIR")
    dev = "cpu" if a.cpu else "cuda"
    scenes = a.scene or ["dragon"]
    workers = [_Worker(*t.split("=", 1), res, dev) for t in a.tree]
    try:
        variants = []
        for w in workers:
            variants += ([(w, True), (w, False)] if w.has_stats
                         else [(w, None)])

        def label(v):
            w, on = v
            return w.name + {True: "+stats", False: "-stats", None: ""}[on]
        out = {"card": card(dev), "res": res, "samples": a.samples,
               "rounds": a.rounds, "order": {}, "rates": {},
               "thread_secs": {}, "ops_a_step": {}}
        if a.count_ops:
            for scene in scenes:
                for w, on in variants:   # the scene's one-time work
                    w.render(scene, on, 1)
                ops = {label(v): v[0].render(scene, v[1], 1, True)
                       ["ops_a_step"] for v in variants}
                out["ops_a_step"][scene] = ops
                print(f"{scene}: PyTorch operator calls a step on "
                      f"{out['card']}: " + ", ".join(
                          f"{k} {n:.1f}" for k, n in ops.items()),
                      flush=True)
            scenes = []
        for scene in scenes:
            for w, on in variants:   # build and warm up
                w.render(scene, on, a.samples)
            rates = {label(v): [] for v in variants}
            cpu = {label(v): [] for v in variants}
            turns = []
            for r in range(a.rounds):
                for v in order(variants, r):
                    got = v[0].render(scene, v[1], a.samples)
                    rates[label(v)].append(got["rays"] / got["secs"])
                    cpu[label(v)].append(got["thread_secs"])
                    turns.append(label(v))
            out["rates"][scene] = rates
            out["order"][scene] = turns
            out["thread_secs"][scene] = cpu
            print(f"{scene}, {a.samples} samples a render, {a.rounds} "
                  f"rounds, camera rays/s on {out['card']}:", flush=True)
            for name, v in rates.items():
                print(f"  {name:<14} mean {statistics.mean(v):.1f} median "
                      f"{statistics.median(v):.1f} runs "
                      + " ".join(f"{x:.1f}" for x in v), flush=True)
            for name, v in cpu.items():
                print(f"  {name:<14} host CPU s a render: median "
                      f"{statistics.median(v):.4f} runs "
                      + " ".join(f"{x:.4f}" for x in v), flush=True)
            print("  in the order " + " ".join(turns), flush=True)
        if a.out:
            os.makedirs(os.path.dirname(os.path.abspath(a.out)),
                        exist_ok=True)
            with open(a.out, "w") as f:
                json.dump(out, f, indent=1)
    finally:
        for w in workers:
            w.close()


if __name__ == "__main__":
    sys.exit(main())
