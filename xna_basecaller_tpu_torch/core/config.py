"""Copied from ``xna_basecaller_tpu/core/config.py``;
only the package imports differ.  ``ModelConfig.package`` keeps the JAX
package's model module as its default, so a model directory written by
either package names the same model family and loads in both.

Model/run configuration: TOML-backed dataclasses.

Speaks the same config.toml schema as the reference model directories
(reference: ub-bonito/bonito/models/xna_r9.4.1_e8_sup@v3.3/config.toml:1-29):
sections [global_norm] [qscore] [input] [model] [labels] [encoder] [basecaller].
Flags override config values at load time, and the merged config is written
back to the training workdir so runs are self-describing (reference:
ub-bonito/bonito/cli/train.py:111-114, util.py:282-293).
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class EncoderConfig:
    stride: int = 5
    activation: str = "swish"
    features: int = 768
    winlen: int = 19
    scale: float = 5.0
    rnn_type: str = "lstm"
    blank_score: float | None = 2.0
    num_rnn_layers: int = 5
    first_conv_size: int = 4
    second_conv_size: int = 16
    extra_linear: bool = False
    drop_rate: float = 0.0
    drop_rate_bottom: float = 0.0


@dataclass(frozen=True)
class BlockConfig:
    """One QuartzNet encoder block (legacy CTC family; reference:
    ub-bonito/bonito/ctc/model.py:68-79 reads these [[block]] sections)."""
    filters: int = 256
    repeat: int = 1
    kernel: tuple[int, ...] = (33,)
    stride: tuple[int, ...] = (1,)
    dilation: tuple[int, ...] = (1,)
    dropout: float = 0.0
    residual: bool = False
    separable: bool = False


@dataclass(frozen=True)
class QScoreConfig:
    bias: float = 0.0
    scale: float = 1.0


@dataclass(frozen=True)
class BasecallerConfig:
    # 256 is the TPU-tuned default (measured fastest through the pipeline
    # on v5e; the reference's 384 is a GPU-memory-era choice and is ~6%
    # slower here steady-state). TOML-loaded reference configs keep their
    # own value.
    batchsize: int = 256
    chunksize: int = 3600
    overlap: int = 500
    quantize: bool = False


@dataclass(frozen=True)
class ModelConfig:
    state_len: int = 3
    labels: tuple[str, ...] = tuple("NACGTXY")
    input_features: int = 1
    package: str = "xna_basecaller_tpu.models.crf_model"
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    qscore: QScoreConfig = field(default_factory=QScoreConfig)
    basecaller: BasecallerConfig = field(default_factory=BasecallerConfig)
    # legacy CTC (QuartzNet) family: non-empty blocks selects the CTC path
    blocks: tuple[BlockConfig, ...] = ()

    @property
    def is_ctc(self) -> bool:
        return bool(self.blocks) or self.package.endswith("ctc_model")

    @property
    def alphabet(self) -> str:
        return "".join(self.labels)

    @property
    def n_base(self) -> int:
        return len(self.labels) - 1

    @property
    def n_state(self) -> int:
        return self.n_base ** self.state_len

    @property
    def n_score(self) -> int:
        return len(self.labels) * self.n_state


def _pick(d: dict, *keys, default=None):
    for k in keys:
        if k in d:
            return d[k]
    return default


def _blocks_from(raw_blocks) -> tuple[BlockConfig, ...]:
    blk_fields = {f.name for f in dataclasses.fields(BlockConfig)}
    out = []
    for b in raw_blocks:
        kw = {k: v for k, v in b.items() if k in blk_fields}
        for key in ("kernel", "stride", "dilation"):
            if key in kw:
                kw[key] = tuple(kw[key])
        out.append(BlockConfig(**kw))
    return tuple(out)


def from_dict(raw: dict[str, Any]) -> ModelConfig:
    enc_raw = dict(raw.get("encoder", {}))
    enc_fields = {f.name for f in dataclasses.fields(EncoderConfig)}
    enc = EncoderConfig(**{k: v for k, v in enc_raw.items() if k in enc_fields})
    qs_raw = raw.get("qscore", {})
    bc_raw = raw.get("basecaller", {})
    bc_fields = {f.name for f in dataclasses.fields(BasecallerConfig)}
    cfg = ModelConfig(
        blocks=_blocks_from(raw.get("block", [])),
        state_len=raw.get("global_norm", {}).get("state_len", 3),
        labels=tuple(raw.get("labels", {}).get("labels", tuple("NACGTXY"))),
        input_features=raw.get("input", {}).get("features", 1),
        package=raw.get("model", {}).get(
            "package", "xna_basecaller_tpu.models.crf_model"),
        encoder=enc,
        qscore=QScoreConfig(bias=qs_raw.get("bias", 0.0),
                            scale=qs_raw.get("scale", 1.0)),
        basecaller=BasecallerConfig(
            **{k: v for k, v in bc_raw.items() if k in bc_fields}),
    )
    return cfg


def to_dict(cfg: ModelConfig) -> dict[str, Any]:
    extra = {}
    if cfg.blocks:
        extra["block"] = [
            {k: (list(v) if isinstance(v, tuple) else v)
             for k, v in dataclasses.asdict(b).items()}
            for b in cfg.blocks]
    return {
        **extra,
        "global_norm": {"state_len": cfg.state_len},
        "qscore": {"bias": cfg.qscore.bias, "scale": cfg.qscore.scale},
        "input": {"features": cfg.input_features},
        "model": {"package": cfg.package},
        "labels": {"labels": list(cfg.labels)},
        "encoder": {
            k: v for k, v in dataclasses.asdict(cfg.encoder).items()
            if v is not None
        },
        "basecaller": dataclasses.asdict(cfg.basecaller),
    }


def load(path: str) -> ModelConfig:
    """Load a config.toml (accepts a model dir or a direct file path)."""
    if os.path.isdir(path):
        path = os.path.join(path, "config.toml")
    with open(path, "rb") as fh:
        return from_dict(tomllib.load(fh))


def _toml_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"%s"' % v.replace("\\", "\\\\").replace('"', '\\"')
    if isinstance(v, (list, tuple)):
        return "[ %s,]" % ", ".join(_toml_value(x) for x in v)
    raise TypeError(f"unsupported TOML value: {v!r}")


def dumps(cfg: ModelConfig | dict) -> str:
    """Minimal TOML emitter (stdlib tomllib is read-only)."""
    raw = to_dict(cfg) if isinstance(cfg, ModelConfig) else cfg
    out = []
    for section, kv in raw.items():
        # array of tables ([[block]] sections, legacy CTC configs)
        entries = kv if isinstance(kv, list) else [kv]
        header = f"[[{section}]]" if isinstance(kv, list) else f"[{section}]"
        for entry in entries:
            out.append(header)
            for k, v in entry.items():
                out.append(f"{k} = {_toml_value(v)}")
            out.append("")
    return "\n".join(out)


def save(cfg: ModelConfig | dict, path: str) -> None:
    """Atomic write: config.toml presence doubles as a done/resume marker
    in the chains (e.g. phase-A bootstrap), so a kill mid-write must not
    leave a truncated file that parses wrong or skips a phase."""
    if os.path.isdir(path):
        path = os.path.join(path, "config.toml")
    from xna_basecaller_tpu_torch.utils.fileio import atomic_output
    with atomic_output(path) as fh:
        fh.write(dumps(cfg))
