"""Execution backend: region evaluator, collectives, sparse tiles."""

from spartan_tpu.backend import evaluator
