#!/usr/bin/env python
"""Multi-host decode benchmark of the PyTorch port — run ONE process per host.

scripts/multihost_bench.py's run on cards: every process encodes the same
columns from the shared seed, places its own shards of each
(``dist.build_sharded_decoder`` on a hosts x cards mesh) and decodes them
with the single-GPU decoders. The decode is collective-free, so
torch.distributed (gloo) carries only the start-up and a closing barrier;
gloo also lets two ranks share one card, which nccl does not.

    # on every host i of N
    python scripts/multihost_bench_torch.py \\
        --coordinator ${HOST0_IP}:29500 --num-hosts N --host-id i \\
        --n 28 --schemes nbit,for,delta,dict,rle

Without --coordinator it runs as one process on ``default_mesh()`` (every
visible card). ``--device cuda:0`` puts each process on that card alone,
``--device cpu`` on the CPU (the kernels' plain versions).

Output: one JSON line on host 0 with per-scheme decoded GB/s across the
slice; compare against a --num-hosts 1 run for the efficiency ratio.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def local_devices(device: str) -> list:
    """This process's devices: every visible card for a bare ``cuda``,
    else the one device named."""
    import torch

    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [d]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None,
                    help="host0 address:port; omit for single-process local run")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--n", type=int, default=26, help="log2 elements per column")
    ap.add_argument("--schemes", default="nbit,for,delta,dict,rle")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (every visible card), cuda:<i> or cpu")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as tdist

    if args.coordinator:
        tdist.init_process_group(
            backend="gloo",
            init_method=f"tcp://{args.coordinator}",
            world_size=args.num_hosts,
            rank=args.host_id,
        )

    from giddy_tpu_torch import api, dist
    from giddy_tpu_torch.datagen import gen_column

    local = local_devices(args.device)
    devices = local * dist.process_rank()[1]  # rank-major, as dist.Mesh reads it
    chips_per_host = len(devices) // max(args.num_hosts, 1)
    if args.num_hosts > 1:
        mesh, axis = dist.host_chip_mesh(args.num_hosts, chips_per_host, devices)
    else:
        mesh, axis = dist.default_mesh(devices=devices), "d"
    n = 1 << args.n

    def sync() -> None:
        for d in local:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # identical columns on every host (shared seed): each process places
    # and decodes only its own shards
    rng = np.random.default_rng(args.seed)
    results: dict[str, dict] = {}
    for scheme in args.schemes.split(","):
        col = api.encode(gen_column(scheme, n, rng), scheme, name=f"mh_{scheme}")
        fn, fargs = dist.build_sharded_decoder(col, mesh, axis)
        fn(*fargs)
        sync()  # placement + first-launch warmup
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            fn(*fargs)
            sync()
            times.append(time.perf_counter() - t0)
        times.sort()
        t = times[len(times) // 2]
        results[scheme] = {
            "decode_GBps_slice": col.nbytes_decoded / 1e9 / t,
            "decode_GBps_per_chip": col.nbytes_decoded / 1e9 / t / len(devices),
            "time_s": t,
        }
        if args.host_id == 0:
            print(f"[mh] {scheme:8s} {results[scheme]['decode_GBps_slice']:9.2f} GB/s "
                  f"({len(devices)} chips, {args.num_hosts} hosts)", file=sys.stderr)

    if args.coordinator:
        tdist.barrier()
        tdist.destroy_process_group()
    if args.host_id == 0:
        line = json.dumps({
            "num_hosts": args.num_hosts,
            "devices": len(devices),
            "n": n,
            "schemes": results,
        })
        print(line)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line)


if __name__ == "__main__":
    main()
