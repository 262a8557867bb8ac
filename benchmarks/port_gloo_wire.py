"""What gloo's collectives cost on one host, by the way they are called.

    PYTHONPATH=src python benchmarks/port_gloo_wire.py [--mb 100] \
        [--repeats 3]

Spawns four processes in a gloo world (a ``FileStore`` in a temporary
directory), two threads each, as ``chip_smoke.py``'s mesh ranks run,
and times, on host tensors, for a group of two ranks (the two pairs at
once, as the ``data`` or the ``model`` axis of a 2 x 2 mesh) and for
the group of all four:

  - a gather of a ``--mb`` MB bf16 block: ``all_gather`` into a list
    and ``torch.cat``; ``all_gather_into_tensor``; an all-reduce of the
    zero-padded whole, viewed as int32;
  - a reduce-scatter of the f32 whole (``--mb`` MB x 2 a rank's part):
    ``reduce_scatter_tensor``; an all-reduce of the whole, then the
    rank's block.

Each is the mean of ``--repeats`` calls after one warm call, between
barriers. It checks that the gathers agree bit for bit and the
reduce-scatters to the last bit, and prints one line a group, with the
host's CPU count and torch's version. Needs no card.
"""
import argparse
import os
import tempfile
import time
import warnings


def rank_main(rank, world, store, mb, repeats):
    import torch
    import torch.distributed as dist
    warnings.filterwarnings("ignore")
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    groups = (("pair", pairs[rank // 2], 2),
              ("four", dist.new_group(list(range(world))), 4))
    for name, group, m in groups:
        n = mb * 500_000 // m * m
        me = dist.get_rank(group)
        block = torch.randn(n).to(torch.bfloat16)
        whole = torch.randn(m * n)

        def timed(fn):
            fn()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(repeats):
                fn()
            dist.barrier()
            return (time.perf_counter() - t0) / repeats

        def listed():
            parts = [torch.empty_like(block) for _ in range(m)]
            dist.all_gather(parts, block, group=group)
            return torch.cat(parts)

        def into():
            out = block.new_empty(m * n)
            dist.all_gather_into_tensor(out, block, group=group)
            return out

        def padded():
            out = torch.zeros(m * n, dtype=torch.bfloat16)
            out[me * n:(me + 1) * n] = block
            dist.all_reduce(out.view(torch.int32), group=group)
            return out

        def scattered():
            out = whole.new_empty(n)
            dist.reduce_scatter_tensor(out, whole, group=group)
            return out

        def reduced():
            out = whole.clone()
            dist.all_reduce(out, group=group)
            return out[me * n:(me + 1) * n]

        ms = {k: timed(f) * 1e3 for k, f in (
            ("all_gather+cat", listed), ("all_gather_into_tensor", into),
            ("all_reduce of the padded whole", padded),
            ("reduce_scatter_tensor f32", scattered),
            ("all_reduce f32 + block", reduced))}
        bits = all(torch.equal(listed().view(torch.int16),
                               f().view(torch.int16)) for f in (into, padded))
        same = torch.equal(scattered(), reduced())
        if rank == 0:
            print(f"{name} ({m} ranks), a {n * 2 / 1e6:.0f} MB bf16 block: "
                  + "; ".join(f"{k} {v:.0f} ms" for k, v in ms.items())
                  + f"; gathers equal bit for bit: {bits}; reduce-scatters "
                  f"equal: {same}", flush=True)
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mb", type=int, default=100)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp
    print(f"torch {torch.__version__}, {os.cpu_count()} CPUs", flush=True)
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(rank_main, args=(4, os.path.join(d, "store"),
                                            args.mb, args.repeats),
                           nprocs=4, start_method="spawn")


if __name__ == "__main__":
    main()
