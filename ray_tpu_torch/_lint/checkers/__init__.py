"""Checker suite of the port's lint — importing this package registers
every checker.

The checkers of ``ray_tpu/_lint/checkers/`` are not ported yet (ROADMAP.md
A7), so none registers and ``run_lint`` finds no checker to run.
"""
