"""xgboost 0.7 gblinear model file codecs.

The 219 shipped GTEx/Roadmap/ENCODE tissue models are xgboost ``.save``
binaries plus ``.dump`` text files produced by xgboost 0.7.post4
(reference train.py:156-159; README.md:8 pins the version). To run them
without the xgboost native library we read/write both formats directly.

Binary layout (xgboost 0.7 ``learner.cc`` / ``gbm/gblinear.cc``):

    [optional 4-byte magic "binf" from the old CLI path — skipped]
    LearnerModelParam   136 bytes: float32 base_score; uint32 num_feature;
                        int32 num_class; int32 contain_extra_attrs;
                        int32 contain_eval_metrics; int32 reserved[29]
    name_obj            uint64 length + bytes        ("reg:linear")
    name_gbm            uint64 length + bytes        ("gblinear")
    GBLinearModelParam  136 bytes: uint32 num_feature; int32 num_output_group;
                        int32 reserved[32]
    weights             uint64 count + count*float32
                        (layout [feature][group], bias per group at the end)
    [optional attributes if contain_extra_attrs]

Text dump layout (consumed by the reference interpreter,
predict_by_cluster.py:73-75):

    bias:
    <bias>
    weight:
    <w_0>
    ...
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..models.gblinear import GBLinearModel

_LEARNER_PARAM = struct.Struct("<fIiii29i")
_GBLINEAR_PARAM = struct.Struct("<Ii32i")
_MAGIC = b"binf"


def save_xgb07_binary(model: GBLinearModel, path: str | os.PathLike, objective: str = "reg:linear") -> None:
    n_feat = model.n_features
    with open(path, "wb") as f:
        f.write(_LEARNER_PARAM.pack(np.float32(model.base_score), n_feat, 0, 0, 0, *([0] * 29)))
        for name in (objective, "gblinear"):
            raw = name.encode()
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
        f.write(_GBLINEAR_PARAM.pack(n_feat, 1, *([0] * 32)))
        weights = np.concatenate([np.asarray(model.weight, np.float32), [np.float32(model.bias)]])
        f.write(struct.pack("<Q", weights.size))
        f.write(weights.astype("<f4").tobytes())


def load_xgb07_binary(path: str | os.PathLike) -> GBLinearModel:
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    if data[:4] == _MAGIC:
        off = 4
    base_score, num_feature, _num_class, extra_attrs, _eval_metrics, *_res = _LEARNER_PARAM.unpack_from(data, off)
    off += _LEARNER_PARAM.size

    def read_str(off):
        (length,) = struct.unpack_from("<Q", data, off)
        off += 8
        return data[off : off + length].decode(), off + length

    name_obj, off = read_str(off)
    name_gbm, off = read_str(off)
    if name_gbm != "gblinear":
        raise ValueError(f"unsupported booster {name_gbm!r} in {path} (only gblinear)")

    gb_num_feature, num_group, *_res2 = _GBLINEAR_PARAM.unpack_from(data, off)
    off += _GBLINEAR_PARAM.size
    (count,) = struct.unpack_from("<Q", data, off)
    off += 8
    weights = np.frombuffer(data, dtype="<f4", count=count, offset=off).astype(np.float32)
    expected = (gb_num_feature + 1) * max(num_group, 1)
    if count != expected:
        raise ValueError(f"{path}: weight count {count} != (num_feature+1)*groups {expected}")
    if num_group not in (0, 1):
        raise ValueError(f"{path}: multi-group gblinear not supported (groups={num_group})")
    return GBLinearModel(
        weight=weights[:gb_num_feature].copy(),
        bias=float(weights[gb_num_feature]),
        base_score=float(base_score),
    )


def parse_dump_text(text: str, base_score: float = 2.0) -> GBLinearModel:
    """Parse a gblinear text dump. ``base_score`` is not stored in dumps;
    callers supply it (the reference default is 2, train.py:49-50)."""
    lines = text.strip("\n").split("\n")
    if not lines[0].startswith("bias"):
        raise ValueError("not a gblinear text dump")
    bias = float(lines[1])
    weights = np.array([float(v) for v in lines[3:]], dtype=np.float32)
    return GBLinearModel(weight=weights, bias=bias, base_score=base_score)


def load_expression_model(path: str | os.PathLike, base_score: float = 2.0) -> GBLinearModel:
    """Load a model in any supported container (binary .save / text dump /
    native .npz), detected by content.

    Whitespace around the path is stripped, as the reference does for every
    modellist entry (predict.py:165 ``load_model(file.strip())``) — modellist
    TSVs commonly carry trailing spaces; a file whose real name ends in a
    space must be passed some other way."""
    p = str(path).strip()
    if p.endswith(".npz"):
        d = np.load(p)
        return GBLinearModel(
            weight=d["weight"].astype(np.float32),
            bias=float(d["bias"]),
            base_score=float(d["base_score"]),
        )
    with open(p, "rb") as f:
        head = f.read(16)
    if head.lstrip()[:5] in (b"bias:",):
        with open(p) as f:
            return parse_dump_text(f.read(), base_score=base_score)
    return load_xgb07_binary(p)
