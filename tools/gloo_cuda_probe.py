#!/usr/bin/env python3
"""Which collectives a gloo group carries for CUDA tensors, with two
processes sharing cuda:0 (as chip_smoke.py's [tp_serve] and
[parallel_tp] ranks do: NCCL refuses two ranks on one device).

    python3 tools/gloo_cuda_probe.py

Each operation runs in a fresh pair of processes, since one that kills
its process must not hide the rest: rank 0 prints "<op>: ok" or the
error it raised, and the launcher prints each pair's exit codes (a
negative code is the signal that killed the process). The last pair
times a 64 MB bf16 all_reduce and all-gather (mean of 3 after one
warm-up). The Python, torch and CUDA versions and the card come first.
"""
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

OPS = ("all_reduce", "all_gather_list", "broadcast",
       "all_gather_into_tensor", "reduce_scatter_tensor",
       "dtensor_shard_to_replicate", "dtensor_partial_to_shard",
       "dtensor_partial_to_replicate", "dtensor_replicate_to_shard_backward",
       "send_recv", "batch_isend_irecv", "big")


def _ops(r, mesh, dev):
    """{name: fn} of the probed operations on rank ``r``."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    x = torch.arange(8, device=dev, dtype=torch.float32) + r
    full = torch.arange(16, device=dev, dtype=torch.float32).reshape(4, 4)

    def send_recv():
        if r == 0:
            dist.send(x, 1)
        else:
            dist.recv(torch.empty_like(x), 0)

    def batch_isend_irecv():
        ops = [dist.P2POp(dist.isend, x, 1 - r),
               dist.P2POp(dist.irecv, torch.empty_like(x), 1 - r)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    def shard_to_replicate():
        d = distribute_tensor(full, mesh, [Shard(0)], src_data_rank=None)
        assert torch.equal(d.redistribute(mesh, [Replicate()]).to_local(),
                           full)

    def partial_to_shard():
        d = DTensor.from_local(full.clone(), mesh, [Partial()])
        assert torch.equal(d.redistribute(mesh, [Shard(0)]).to_local(),
                           2 * full[2 * r:2 * r + 2])

    def partial_to_replicate():
        d = DTensor.from_local(full.clone(), mesh, [Partial()])
        assert torch.equal(d.redistribute(mesh, [Replicate()]).to_local(),
                           2 * full)

    def replicate_to_shard_backward():
        p = distribute_tensor(full, mesh, [Replicate()],
                              src_data_rank=None).requires_grad_()
        p.redistribute(mesh, [Shard(0)]).to_local(
            grad_placements=[Shard(0)]).sum().backward()
        assert torch.equal(p.grad.to_local(), torch.ones_like(full))

    return {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather_list": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(2)], x),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(16, device=dev), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), x),
        "dtensor_shard_to_replicate": shard_to_replicate,
        "dtensor_partial_to_shard": partial_to_shard,
        "dtensor_partial_to_replicate": partial_to_replicate,
        "dtensor_replicate_to_shard_backward": replicate_to_shard_backward,
        "send_recv": send_recv,
        "batch_isend_irecv": batch_isend_irecv,
    }


def _time_big(dev):
    big = torch.randn(8192 * 4096, device=dev, dtype=torch.bfloat16)
    out = torch.empty(2 * big.numel(), device=dev, dtype=big.dtype)
    res = {}
    for name, fn in (("all_reduce_64MB", lambda: dist.all_reduce(big)),
                     ("all_gather_64MB",
                      lambda: dist.all_gather_into_tensor(out, big))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        res[name] = f"{(time.perf_counter() - t0) / 3 * 1e3:.1f} ms"
    return res


def rank_main(r: int, port: int, op: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=r, world_size=2)
    dev = torch.device("cuda:0")
    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("tp",))
    if op == "big":
        res = _time_big(dev)
    else:
        try:
            _ops(r, mesh, dev)[op]()
            torch.cuda.synchronize()
            res = {op: "ok"}
        except (RuntimeError, AssertionError) as exc:
            res = {op: f"FAIL {type(exc).__name__}: {str(exc)[:160]}"}
    if r == 0:
        for name, value in res.items():
            print(f"{name}: {value}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    for op in OPS:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, __file__, "rank", str(r),
                                   str(port), op],
                                  stderr=subprocess.DEVNULL)
                 for r in range(2)]
        try:
            rcs = [p.wait(timeout=60) for p in procs]
        except subprocess.TimeoutExpired:
            rcs = "timeout"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        print(op, "rcs", rcs, flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
