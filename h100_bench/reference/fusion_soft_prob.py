"""Soft fusion with the fused probability as the confidence: the port's
`PseudoLabelGenerator(mode="soft", conf_mode="prob")`, checked by the
plain `pipeline.soft_fusion`."""

from h100_bench.reference.pipeline import soft_fusion as fuse  # noqa: F401

PROGRAM = {"mode": "soft", "conf_mode": "prob"}
