"""Port of ``ray_tpu/autoscaler/monitor.py``.

Autoscaler monitor daemon: the process `ray up` leaves running.

Counterpart of the reference's monitor (reference:
python/ray/autoscaler/_private/monitor.py — the head-side process that owns
the StandardAutoscaler and, on teardown, releases every node).  The monitor
OWNS the provider: for the fake cloud that means the simulated slices (and
their real local nodelet processes) live and die with this process — a
SIGTERM drains them before exit, which is exactly what `ray down` sends.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

logger = logging.getLogger(__name__)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ray_tpu_torch.autoscaler.monitor")
    parser.add_argument("config", help="cluster YAML path")
    parser.add_argument("--address", required=True, help="GCS host:port")
    parser.add_argument("--session-dir", default=None)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ray_tpu_torch._private import rpc
    from ray_tpu_torch._private.rpc import EventLoopThread
    from ray_tpu_torch.autoscaler.autoscaler import (AutoscalingConfig,
                                               StandardAutoscaler)
    from ray_tpu_torch.autoscaler.launcher import load_cluster_config, make_provider

    config = load_cluster_config(args.config)
    host, port = args.address.rsplit(":", 1)
    gcs_addr = (host, int(port))

    io = EventLoopThread()
    conn = io.run(rpc.connect(*gcs_addr, name="monitor->gcs"))

    def gcs_call(method, msg):
        return io.run(conn.call(method, msg))

    provider = make_provider(config, gcs_addr=gcs_addr,
                             session_dir=args.session_dir)
    scaler = StandardAutoscaler(
        AutoscalingConfig(node_types=config.node_types,
                          max_workers=config.max_workers,
                          idle_timeout_s=config.idle_timeout_s,
                          update_interval_s=1.0),
        provider, gcs_call)
    scaler.start()
    logger.info("monitor up for cluster %s (%d node types)",
                config.cluster_name, len(config.node_types))

    stop = threading.Event()

    def _teardown(signum, frame):
        logger.info("monitor received signal %d: tearing down", signum)
        stop.set()

    signal.signal(signal.SIGTERM, _teardown)
    signal.signal(signal.SIGINT, _teardown)
    stop.wait()
    scaler.stop()
    # release every node: slice-atomic providers reap whole slices
    try:
        for node in provider.non_terminated_nodes({}):
            provider.terminate_node(node)
        provider.shutdown()
    except Exception:
        logger.exception("provider teardown failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
