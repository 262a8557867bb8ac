"""What a ``torch.profiler`` capture started on a second thread records:
the cases behind ``repro_torch.obs.server``'s ``/debug/profile``
(ROADMAP C15, C16).

    PYTHONPATH=src python benchmarks/port_profile_threads.py \\
        [--device cpu] [--captures 15] [--ms 300]

Each mode runs in a fresh process (Kineto's state is process-wide), with
a load thread doing small device ops and a readback in a loop (100 done
before the first capture) while a second thread captures ``--ms``
milliseconds:

- ``second_thread``: the process's first profiler session starts on the
  capture thread, default config (one capture);
- ``second_thread_all``: the same with ``profile_all_threads``;
- ``server_ungated``: the port's ``TelemetryServer`` built on the main
  thread (its ``init_profiler``), then ``--captures`` captures in a row
  by its ``capture``, while the load launches without the launch gate;
- ``server``: the same with the load holding
  ``repro_torch.device.LAUNCHES`` shared around each step, as the search
  engine's uploads, launches and readbacks do.

Per mode it prints whether stderr holds ``External init callback``, the
CPU ops of the load thread and of the capture thread in the first
capture, the CUDA kernels of each capture (with ``--device cuda``), how
many captures recorded none, and the first capture's seconds. The card
is the default device.
"""
import argparse
import contextlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

MODES = ("second_thread", "second_thread_all", "server_ungated", "server")


def child(mode, device, ms, captures, out_dir):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.device import LAUNCHES
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    server = None
    if mode.startswith("server"):
        from repro_torch.obs import Obs
        from repro_torch.obs.server import TelemetryServer
        server = TelemetryServer(Obs(), profile_dir=out_dir, device=device)
    gated = mode == "server"
    stop, running, tids = threading.Event(), threading.Event(), {}

    def load():
        tids["load"] = threading.get_native_id()
        a = torch.randn(2048, 64, device=device)
        for i in itertools.count():
            if stop.is_set():
                return
            with (LAUNCHES.launching() if gated else
                  contextlib.nullcontext()):
                for _ in range(10):
                    b = (a * 1.5).sum(1)
                b.topk(8).values.cpu()
            if i == 100:                # past the device's first use
                running.set()

    def capture(n):
        t0 = time.perf_counter()
        if server is not None:
            return server.capture(ms), time.perf_counter() - t0
        kw = {}
        if mode == "second_thread_all":
            kw["experimental_config"] = torch.profiler._ExperimentalConfig(
                profile_all_threads=True)
        with profile(activities=acts, **kw) as prof:
            time.sleep(ms / 1e3)
        path = os.path.join(out_dir, f"{mode}-{n}.json")
        prof.export_chrome_trace(path)
        return path, time.perf_counter() - t0

    def captures_in_a_row():
        tids["capture"] = threading.get_native_id()
        for n in range(captures if server is not None else 1):
            path, seconds = capture(n)
            events = json.load(open(path))["traceEvents"]
            os.unlink(path)
            tids.setdefault("kernels", []).append(
                sum(e.get("cat") == "kernel" for e in events))
            if n == 0:
                ops = [e.get("tid") for e in events
                       if e.get("cat") == "cpu_op"]
                tids["first"] = (ops.count(tids["load"]),
                                 ops.count(tids["capture"]), seconds)

    loader = threading.Thread(target=load)
    loader.start()
    running.wait()
    cap = threading.Thread(target=captures_in_a_row)
    cap.start()
    cap.join()
    stop.set()
    loader.join()
    if server is not None:
        server.close()
    load_ops, cap_ops, seconds = tids["first"]
    print(json.dumps({
        "load_thread_ops": load_ops, "capture_thread_ops": cap_ops,
        "kernels": tids["kernels"],
        "captures_without_kernels": tids["kernels"].count(0),
        "first_seconds": round(seconds, 3)}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ms", type=int, default=300)
    ap.add_argument("--captures", type=int, default=15,
                    help="captures in a row in the server modes")
    ap.add_argument("--child", choices=MODES, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child, args.device, args.ms, args.captures, args.out)
        return 0
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("port_profile_threads: no CUDA card (--device cpu runs on "
              "the CPU)", file=sys.stderr)
        return 2
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu")
    print(f"device {where}; torch {torch.__version__}; capture {args.ms} "
          f"ms; {args.captures} captures in a row in the server modes")
    with tempfile.TemporaryDirectory() as out:
        for mode in MODES:
            r = subprocess.run(
                [sys.executable, __file__, "--child", mode, "--device",
                 args.device, "--ms", str(args.ms), "--captures",
                 str(args.captures), "--out", out],
                capture_output=True, text=True, timeout=1200)
            if r.returncode != 0:
                print(f"{mode}: rc {r.returncode}\n{r.stderr[-2000:]}")
                return 1
            row = json.loads(r.stdout.strip().splitlines()[-1])
            row["external_init_error"] = (
                "External init callback" in r.stderr)
            print(f"{mode}: {json.dumps(row)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
