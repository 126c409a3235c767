"""Port of ``ray_tpu/_private/worker_main.py``.

Worker process entry point.

Counterpart of the reference's default_worker.py (reference:
python/ray/_private/workers/default_worker.py): connect to the local nodelet +
GCS, register, then serve the task-execution loop until killed.
"""

from __future__ import annotations

import argparse
import logging
import sys

from ray_tpu_torch._private.config import temp_root


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--nodelet-host", required=True)
    parser.add_argument("--nodelet-port", type=int, required=True)
    parser.add_argument("--gcs-host", required=True)
    parser.add_argument("--gcs-port", type=int, required=True)
    parser.add_argument("--worker-id", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--session-dir", default=temp_root())
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, format="[worker] %(levelname)s %(message)s")

    # SIGUSR1 dumps all thread stacks to stderr -> worker log (out-of-band
    # fallback when the RPC plane is wedged; the primary live-stack surface
    # is the nodelet's dump_stacks RPC served by CoreWorker, which feeds
    # `ray_tpu_torch stack` / the dashboard with zero external deps).
    import faulthandler
    import signal
    import threading

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    # name the main thread so stack dumps read as "what is this thread FOR"
    # rather than a bare MainThread parked on the shutdown event
    threading.current_thread().name = "worker-main-wait"

    from ray_tpu_torch._private import bench_rig
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.core_worker import CoreWorker
    from ray_tpu_torch._private.ids import NodeID, WorkerID

    # Bench rig: when the driver exported a pin pool, take a core before
    # any threads start (no-op outside rig runs / on 1-core boxes).
    bench_rig.maybe_pin_from_env()

    core = CoreWorker(
        mode="worker",
        gcs_addr=(args.gcs_host, args.gcs_port),
        nodelet_addr=(args.nodelet_host, args.nodelet_port),
        worker_id=WorkerID.from_hex(args.worker_id),
        node_id=NodeID.from_hex(args.node_id),
        session_dir=args.session_dir,
    )
    worker_mod.set_global_core(core)
    core.register_with_nodelet()
    # Block forever; the nodelet owns this process's lifetime.
    core.shutdown_event.wait()


if __name__ == "__main__":
    main()
