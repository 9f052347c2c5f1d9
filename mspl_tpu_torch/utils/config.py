"""Typed workload configs keyed to the five BASELINE configs (port of
mspl_tpu/utils/config.py, copied: typed dataclass configs and a registry
that the command line maps onto)."""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class WorkloadConfig:
    """One named end-to-end workload (maps to a CLI invocation)."""

    name: str
    description: str
    command: str  # cli subcommand
    dataset: Optional[str] = None
    model: str = "espnetv2"
    s: float = 2.0
    size_wh: Optional[Tuple[int, int]] = None
    batch_size: int = 8
    fusion: str = "soft"
    rounds: int = 1
    p_init: float = 0.2
    p_step: float = 0.05
    extra: Dict = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return asdict(self)


# BASELINE.json:7-12, one entry per configuration
WORKLOADS: Dict[str, WorkloadConfig] = {
    "camvid_inference": WorkloadConfig(
        name="camvid_inference",
        description="ESPNetv2 single-source CamVid inference (480x360, 11 "
                    "classes, CPU-runnable)",  # config #1
        command="eval", dataset="camvid", size_wh=(480, 360),
    ),
    "single_source_pseudo": WorkloadConfig(
        name="single_source_pseudo",
        description="Single-source pseudo-label gen: softmax+argmax+conf "
                    "threshold, Cityscapes model -> greenhouse",  # config #2
        command="pseudo", dataset="cityscapes", size_wh=(480, 256),
    ),
    "multi_source_fusion": WorkloadConfig(
        name="multi_source_fusion",
        description="Multi-source soft pseudo-label fusion (CamVid + "
                    "Cityscapes + Freiburg Forest models)",  # config #3
        command="pseudo", size_wh=(480, 256), fusion="soft",
    ),
    "self_training_round": WorkloadConfig(
        name="self_training_round",
        description="One self-training round: fused label gen + ESPNetv2 "
                    "fine-tune, data-parallel",  # config #4
        command="selftrain", size_wh=(480, 256), rounds=1,
    ),
    "full_curriculum": WorkloadConfig(
        name="full_curriculum",
        description="Full MSPL multi-round curriculum with class-balanced "
                    "thresholds + DeepLab backbone swap",  # config #5
        command="selftrain", size_wh=(480, 256), rounds=3,
        extra={"alt_model": "deeplabv3"},
    ),
}


def get_workload(name: str) -> WorkloadConfig:
    try:
        return WORKLOADS[name]
    except KeyError:
        raise ValueError(f"unknown workload '{name}'; have "
                         f"{sorted(WORKLOADS)}") from None
