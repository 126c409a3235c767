"""Port of ``ray_tpu/dashboard/__main__.py``.

`python -m ray_tpu_torch.dashboard --address HOST:PORT [--port N]`."""

import argparse

from ray_tpu_torch.dashboard import run

parser = argparse.ArgumentParser()
parser.add_argument("--address", required=True)
parser.add_argument("--host", default="127.0.0.1")
parser.add_argument("--port", type=int, default=8265)
args = parser.parse_args()
run(args.address, host=args.host, port=args.port)
