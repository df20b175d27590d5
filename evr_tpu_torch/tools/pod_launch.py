"""Local multi-process launcher.

Counterpart of ``evr_tpu/tools/pod_launch.py``: spawns N copies of a command
with the ``parallel.multihost.bootstrap`` environment contract
(``EVR_TPU_COORDINATOR``, ``EVR_TPU_NUM_PROCESSES``, ``EVR_TPU_PROCESS_ID``).
``--cpu-devices K`` gives each
process K CPU slots (``EVR_TPU_CPU_DEVICES``) and one intra-op thread
(``OMP_NUM_THREADS=1``, unless set), so that N processes of small tensor
work do not oversubscribe the cores; the command still picks its device
(``--device cpu``).

Example, two processes of two CPU slots each::

    python -m evr_tpu_torch.tools.pod_launch -n 2 --cpu-devices 2 -- \\
        python -m evr_tpu_torch.tools.finetune --device cpu --fsdp \\
        --train-json a.json --data-dir d/

The exit status is non-zero if any worker fails; on the first failure the
remaining workers are terminated (a rank that died leaves its peers waiting
in their next collective).
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(
    cmd: list[str],
    num_processes: int,
    cpu_devices: int | None = None,
    coordinator_port: int | None = None,
    prefix_output: bool = True,
) -> int:
    """Spawn ``cmd`` ``num_processes`` times with the bootstrap environment;
    returns the first non-zero return code (0 if every worker succeeds)."""
    port = coordinator_port or _free_port()
    procs: list[subprocess.Popen] = []
    for pid in range(num_processes):
        env = dict(os.environ)
        env.update(
            EVR_TPU_COORDINATOR=f"localhost:{port}",
            EVR_TPU_NUM_PROCESSES=str(num_processes),
            EVR_TPU_PROCESS_ID=str(pid),
        )
        if cpu_devices:
            env["EVR_TPU_CPU_DEVICES"] = str(cpu_devices)
            env.setdefault("OMP_NUM_THREADS", "1")
        procs.append(subprocess.Popen(
            cmd, env=env,
            stdout=subprocess.PIPE if prefix_output else None,
            stderr=subprocess.STDOUT if prefix_output else None,
            text=prefix_output,
        ))
    threads = []
    if prefix_output:
        def pump(pid: int, p: subprocess.Popen) -> None:
            for line in p.stdout:  # type: ignore[union-attr]
                sys.stdout.write(f"[proc {pid}] {line}")
                sys.stdout.flush()

        threads = [threading.Thread(target=pump, args=(i, p), daemon=True)
                   for i, p in enumerate(procs)]
        for t in threads:
            t.start()
    rc = 0
    try:
        remaining = set(range(num_processes))
        while remaining:
            for i in list(remaining):
                code = procs[i].poll()
                if code is None:
                    continue
                remaining.discard(i)
                if code != 0 and rc == 0:
                    rc = code
                    for j in remaining:  # a dead rank wedges every later collective
                        procs[j].terminate()
            if remaining:
                time.sleep(0.1)
    except KeyboardInterrupt:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        rc = 130
    for p in procs:
        p.wait()
    for t in threads:
        t.join(timeout=5)
    return rc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="spawn N multi-process workers locally",
        usage="python -m evr_tpu_torch.tools.pod_launch -n N [--cpu-devices K] -- CMD...",
    )
    ap.add_argument("-n", "--num-processes", type=int, required=True)
    ap.add_argument("--cpu-devices", type=int, default=None,
                    help="CPU slots a process's mesh takes (EVR_TPU_CPU_DEVICES)")
    ap.add_argument("--port", type=int, default=None, help="coordinator port")
    ap.add_argument("--no-prefix", action="store_true",
                    help="inherit stdout instead of '[proc N]'-prefixed lines")
    ap.add_argument("cmd", nargs=argparse.REMAINDER, help="command to run (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no command given (use: pod_launch -n 2 -- python ...)")
    raise SystemExit(launch(cmd, args.num_processes, args.cpu_devices, args.port,
                            prefix_output=not args.no_prefix))


if __name__ == "__main__":
    main()
