"""End-to-end Deep RC training entry point of the port (mirror of
``repro.launch.train``).

The full paper pipeline as ONE stage graph under the port's Session:

  synthetic corpus -> Cylon-analogue Table -> LM train loop (microbatched,
  AdamW, flash attention on the card) -> async checkpointing (+restart)
  -> postprocess (loss drop)

Under ``--kind-pods`` the same graph runs with its data-engineering stage
placed on a data pod and its DL stages on a DL pod — per-stage placement,
the dependency edge crossing pilots; a machine with one card falls back
to one shared pod, as the JAX package's does.  Every stage runs on the
device its communicator was carved on: the card unless ``--device cpu``.

CLI:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 10 --batch 8 --seq 512
  ... --smoke --device cpu --steps 3 --batch 2 --seq 32   # on the CPU
  ... --resume                                  # restart from checkpoint
  ... --kind-pods                               # data vs DL kind-split pilots

``--arch`` defaults to the JAX package's ``xlstm-125m``, whose recurrent
blocks the port does not run yet: it raises the model layer's
``NotImplementedError`` before any pilot is acquired.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs import RunConfig, get_config
from repro_torch.core import Session, stage
from repro_torch.core.pilot import PilotDescription, PilotManager
from repro_torch.dataframe.table import Table
from repro_torch.launch.mesh import resolve_device
from repro_torch.train.state import init_train_state, model_specs
from repro_torch.train.step import make_train_step


def make_corpus(vocab: int, n_tokens: int, seed: int = 0) -> np.ndarray:
    """Synthetic Zipf-ish corpus with local structure (learnable bigrams)."""
    rng = np.random.default_rng(seed)
    base = rng.zipf(1.3, size=n_tokens).clip(max=vocab - 1)
    # inject deterministic bigram structure so loss can actually drop
    base[1::2] = (base[::2][: len(base[1::2])] * 7 + 3) % vocab
    return base.astype(np.int32)


def run(args) -> dict:
    cfg = get_config(args.arch, smoke=args.smoke)
    model_specs(cfg)  # an architecture the port cannot build raises here
    run_cfg = RunConfig(num_microbatches=args.microbatches,
                        learning_rate=args.lr)
    ckpt_dir = args.ckpt_dir or os.path.join("results", "ckpt", cfg.name)
    dev = resolve_device(args.device)

    # kind-aware pods: split the machine into a data-engineering pod and a
    # DL pod (PilotDescription(task_kinds=...)); the Session's placement
    # policy routes each STAGE to the pod admitting its kind, so the DAG
    # below stays ONE pipeline whose dependency edges cross pilots.
    # Falls back to one shared pod when the machine cannot back two pools.
    pm = PilotManager(devices=[dev] if dev.type == "cpu" else None)
    kind_pods = args.kind_pods and pm.free_devices() >= 2
    if kind_pods:
        n_data = max(1, pm.free_devices() // 4)
        pods = [
            PilotDescription(num_devices=n_data, name="pod-data",
                             task_kinds=("data_engineering",)),
            PilotDescription(name="pod-dl",
                             task_kinds=("train", "inference")),
        ]
    else:
        pods = None
    session = Session(manager=pm, pods=pods, max_workers_per_pilot=2)

    @stage(kind="data_engineering")
    def preprocess(ctx):
        corpus = make_corpus(cfg.vocab_size, args.batch * args.seq * (args.steps + 8))
        n_rows = len(corpus) // args.seq
        rows = corpus[: n_rows * args.seq].reshape(n_rows, args.seq)
        return Table.from_columns(
            {"tokens": rows, "row_id": np.arange(n_rows, dtype=np.int32)},
            device=ctx.comm.device)

    @stage(kind="train", checkpoint=ckpt_dir)
    def train(ctx):
        table = ctx.upstream["preprocess"]
        state = init_train_state(
            torch.Generator(device=ctx.comm.device).manual_seed(args.seed),
            cfg, run_cfg, device=ctx.comm.device)
        start_step = 0
        # ctx.resume_step is threaded in by the agent on checkpoint-aware
        # retry (the stage declares checkpoint=); --resume covers the
        # cold-start case where the user restarts the whole run
        resume_from = ctx.resume_step
        if resume_from is None and args.resume:
            resume_from = store.latest_step(ckpt_dir)
        if resume_from is not None:
            state = store.restore(ckpt_dir, state, step=resume_from)
            start_step = int(state["step"])
            print(f"[train] resumed from step {start_step}")
        step_fn = make_train_step(cfg, run_cfg)
        ckpt = store.AsyncCheckpointer(ckpt_dir, keep=2)
        # the data pod's table, on this stage's device
        tokens = table.col("tokens").to(ctx.comm.device)
        n_rows = tokens.shape[0]
        losses = []
        t0 = time.time()
        for i in range(start_step, args.steps):
            lo = (i * args.batch) % max(n_rows - args.batch, 1)
            chunk = tokens[lo:lo + args.batch]
            batch = {"tokens": chunk, "labels": torch.roll(chunk, -1, dims=1)}
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            if args.ckpt_every and (i + 1) % args.ckpt_every == 0:
                ckpt.save(i + 1, state)
            if (i + 1) % max(args.steps // 10, 1) == 0:
                dt = (time.time() - t0) / (i + 1 - start_step)
                print(f"[train] step {i+1}/{args.steps} loss={losses[-1]:.4f} "
                      f"({dt:.2f}s/step)", flush=True)
        ckpt.save(args.steps, state)
        ckpt.close()
        return {"losses": losses, "state_step": int(state["step"]),
                "train_s": time.time() - t0}

    @stage(kind="inference")
    def postprocess(ctx):
        r = ctx.upstream["train"]
        first = np.mean(r["losses"][:5]) if len(r["losses"]) >= 5 else r["losses"][0]
        last = np.mean(r["losses"][-5:])
        return {"first_loss": float(first), "last_loss": float(last),
                "improved": bool(last < first), "train_s": r["train_s"],
                "steps": len(r["losses"])}

    # ONE pipeline regardless of pod layout: under --kind-pods the
    # preprocess stage resolves to pod-data and train/postprocess to
    # pod-dl, with the dependency edge crossing agents.  Session.close()
    # (the context manager) recycles agents AND pilots on every exit path.
    with session:
        pipe = session.start(preprocess >> train >> postprocess,
                             name=f"train-{cfg.name}")
        pipe.wait()
        if pipe.error is not None:
            raise RuntimeError(f"pipeline {pipe.name} {pipe.error}")
        out = pipe.results
    res = out["postprocess"]
    # the paper's Table 2 decomposition: queue, communicator, execute
    res["overheads"] = {**pipe.tasks["train"].overhead_s,
                        "execute": pipe.tasks["train"].duration_s}
    res["placement"] = pipe.stage_placements()
    res["kind_pods"] = {p.uid: sorted(p.task_kinds) for p in session.pilots} \
        if kind_pods else None
    print(f"[deep-rc] {cfg.name}: loss {res['first_loss']:.4f} -> "
          f"{res['last_loss']:.4f} in {res['steps']} steps "
          f"({res['train_s']:.1f}s); runtime overheads: {res['overheads']}; "
          f"placement: {res['placement']}")
    return res


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--kind-pods", action="store_true",
                    help="split data-engineering vs DL stages onto "
                         "kind-specialised pilots (needs >= 2 devices)")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is asked for")
    return ap


if __name__ == "__main__":
    run(build_parser().parse_args())
