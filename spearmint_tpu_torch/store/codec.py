"""Experiment-config and job codec.

Copy of ``spearmint_tpu/store/codec.py`` (the port imports nothing of the JAX
package).  Job files and configs written by either package load in the
other.

Parity: reference ``spearmint.proto`` + ``helpers.py`` (SURVEY.md §2
#14/#15).  The experiment config grammar is the reference's protobuf
**text format** (``config.pb``) — parsed here with a self-contained
recursive parser so no protoc codegen step is needed — and a JSON config
is accepted as the idiomatic alternative.  Jobs are serialized as JSON
(the reference used binary protobuf; the wire format is private to this
framework so the idiomatic choice wins, but the field set matches the
reference ``Job`` message: id, expt_dir, name, language, params, value,
duration, status).

Reference message schema being mirrored (spearmint.proto ≈L1-60):
  Experiment { name, language ∈ {MATLAB, PYTHON, SHELL, MCR},
               repeated Parameter { name, type ∈ {INT, FLOAT, ENUM},
                                    size, options, min, max } }
  Job { id, expt_dir, name, language, repeated Parameter w/
        int_val/dbl_val/str_val, value, duration, status }
"""

from __future__ import annotations

import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Any

LANGUAGES = ("PYTHON", "MATLAB", "SHELL", "MCR")
PARAM_TYPES = ("INT", "FLOAT", "ENUM")


@dataclass
class VariableSpec:
    name: str
    type: str            # INT | FLOAT | ENUM
    size: int = 1
    min: float | None = None
    max: float | None = None
    options: list[str] = field(default_factory=list)

    def validate(self):
        if self.type not in PARAM_TYPES:
            raise ValueError(f"variable {self.name}: bad type {self.type}")
        if self.type == "ENUM":
            if not self.options:
                raise ValueError(f"ENUM variable {self.name} needs options")
        else:
            if self.min is None or self.max is None:
                raise ValueError(f"variable {self.name} needs min and max")
            if self.max <= self.min:
                raise ValueError(f"variable {self.name}: max <= min")


@dataclass
class ExperimentConfig:
    name: str
    language: str
    variables: list[VariableSpec] = field(default_factory=list)

    @property
    def grid_dims(self) -> int:
        return sum(v.size for v in self.variables)

    def validate(self):
        if self.language not in LANGUAGES:
            raise ValueError(f"bad language {self.language}")
        for v in self.variables:
            v.validate()


@dataclass
class Parameter:
    name: str
    int_val: list[int] = field(default_factory=list)
    dbl_val: list[float] = field(default_factory=list)
    str_val: list[str] = field(default_factory=list)


@dataclass
class Job:
    id: int
    expt_dir: str
    name: str
    language: str
    params: list[Parameter] = field(default_factory=list)
    value: float | None = None
    duration: float | None = None
    status: str = "submitted"
    submit_t: float = 0.0
    start_t: float = 0.0
    end_t: float = 0.0


# ------------------------------------------------------ text-format parser
_TOKEN_RE = re.compile(
    r"""
    (?P<string>"(?:[^"\\]|\\.)*")
    | (?P<punct>[{}:])
    | (?P<atom>[^\s{}:"]+)
    """,
    re.VERBOSE,
)


def _tokenize(text: str):
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        for m in _TOKEN_RE.finditer(line):
            if m.lastgroup == "string":
                yield ("string", json.loads(m.group()))
            elif m.lastgroup == "punct":
                yield ("punct", m.group())
            else:
                yield ("atom", m.group())


def _parse_message(tokens: list, pos: int) -> tuple[dict, int]:
    """Parse a proto-text message body into {field: [values...]}."""
    out: dict[str, list[Any]] = {}
    n = len(tokens)
    while pos < n:
        kind, val = tokens[pos]
        if kind == "punct" and val == "}":
            return out, pos + 1
        if kind != "atom":
            raise ValueError(f"expected field name, got {val!r}")
        name = val
        pos += 1
        if pos >= n:
            raise ValueError(f"dangling field {name!r}")
        kind, val = tokens[pos]
        if kind == "punct" and val == "{":
            sub, pos = _parse_message(tokens, pos + 1)
            out.setdefault(name, []).append(sub)
        elif kind == "punct" and val == ":":
            pos += 1
            if pos >= n:
                raise ValueError(f"field {name!r} missing value")
            vkind, vval = tokens[pos]
            if vkind == "punct" and vval == "{":
                sub, pos = _parse_message(tokens, pos + 1)
                out.setdefault(name, []).append(sub)
            else:
                out.setdefault(name, []).append(vval)
                pos += 1
        else:
            raise ValueError(f"expected ':' or '{{' after {name!r}")
    return out, pos


def parse_text_config(text: str) -> ExperimentConfig:
    tokens = list(_tokenize(text))
    msg, pos = _parse_message(tokens, 0)
    if pos != len(tokens):
        raise ValueError("trailing tokens in config")

    def scalar(d, key, default=None):
        v = d.get(key)
        return v[0] if v else default

    variables = []
    for v in msg.get("variable", []):
        if not isinstance(v, dict):
            raise ValueError("variable must be a message block")
        variables.append(
            VariableSpec(
                name=str(scalar(v, "name", "")),
                type=str(scalar(v, "type", "FLOAT")).upper(),
                size=int(scalar(v, "size", 1)),
                min=(None if scalar(v, "min") is None
                     else float(scalar(v, "min"))),
                max=(None if scalar(v, "max") is None
                     else float(scalar(v, "max"))),
                options=[str(o) for o in v.get("options", [])],
            )
        )
    cfg = ExperimentConfig(
        name=str(scalar(msg, "name", "experiment")),
        language=str(scalar(msg, "language", "PYTHON")).upper(),
        variables=variables,
    )
    cfg.validate()
    return cfg


def parse_json_config(text: str) -> ExperimentConfig:
    d = json.loads(text)
    variables = [
        VariableSpec(
            name=v["name"], type=v["type"].upper(), size=int(v.get("size", 1)),
            min=v.get("min"), max=v.get("max"),
            options=list(v.get("options", [])),
        )
        for v in d.get("variables", d.get("variable", []))
    ]
    cfg = ExperimentConfig(
        name=d.get("name", "experiment"),
        language=d.get("language", "PYTHON").upper(),
        variables=variables,
    )
    cfg.validate()
    return cfg


def load_experiment(path: str) -> ExperimentConfig:
    """Reference ``helpers.load_experiment`` — sniffs text-proto vs JSON."""
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("{"):
        return parse_json_config(text)
    return parse_text_config(text)


# --------------------------------------------------------------- job io
def job_file_for(expt_dir: str, job_id: int) -> str:
    return os.path.join(expt_dir, "jobs", f"{job_id:08d}.json")


def job_output_file(expt_dir: str, job_id: int) -> str:
    return os.path.join(expt_dir, "output", f"{job_id:08d}.out")


def save_job(job: Job) -> str:
    path = job_file_for(job.expt_dir, job.id)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "id": job.id, "expt_dir": job.expt_dir, "name": job.name,
        "language": job.language, "value": job.value,
        "duration": job.duration, "status": job.status,
        "submit_t": job.submit_t, "start_t": job.start_t, "end_t": job.end_t,
        "params": [
            {"name": p.name, "int_val": p.int_val, "dbl_val": p.dbl_val,
             "str_val": p.str_val}
            for p in job.params
        ],
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)  # atomic: runners never see torn writes
    return path


def load_job(path: str) -> Job:
    with open(path) as f:
        d = json.load(f)
    return Job(
        id=int(d["id"]), expt_dir=d["expt_dir"], name=d["name"],
        language=d["language"], value=d.get("value"),
        duration=d.get("duration"), status=d.get("status", "submitted"),
        submit_t=d.get("submit_t", 0.0), start_t=d.get("start_t", 0.0),
        end_t=d.get("end_t", 0.0),
        params=[
            Parameter(name=p["name"], int_val=list(p.get("int_val", [])),
                      dbl_val=list(p.get("dbl_val", [])),
                      str_val=list(p.get("str_val", [])))
            for p in d.get("params", [])
        ],
    )


def params_to_dict(params: list[Parameter]) -> dict[str, Any]:
    """The dict handed to user code's ``main(job_id, params)`` — value
    arrays exactly as the reference runner builds them."""
    import numpy as np

    out = {}
    for p in params:
        if p.int_val:
            out[p.name] = np.array(p.int_val)
        elif p.dbl_val:
            out[p.name] = np.array(p.dbl_val)
        else:
            out[p.name] = p.str_val
    return out


def log(msg: str) -> None:
    """Reference ``helpers.log``: timestamped line to stdout."""
    print(f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {msg}", flush=True)
