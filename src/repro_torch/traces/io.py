"""JSONL persistence for trace corpora (one program per line)."""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.core.types import ProgramTrace, RequestRecord


def save_corpus(corpus: list[ProgramTrace], path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with tmp.open("w") as f:
        for tr in corpus:
            f.write(
                json.dumps(
                    {
                        "program_id": tr.program_id,
                        "steps": [
                            [
                                s.input_tokens,
                                s.output_tokens,
                                round(s.tool_duration_s, 4),
                                round(s.reasoning_wall_s, 4),
                                s.tool_kind,
                            ]
                            for s in tr.steps
                        ],
                    }
                )
                + "\n"
            )
    tmp.rename(path)  # atomic publish


def load_corpus(path: str | Path) -> list[ProgramTrace]:
    out: list[ProgramTrace] = []
    with Path(path).open() as f:
        for line in f:
            d = json.loads(line)
            out.append(
                ProgramTrace(
                    program_id=d["program_id"],
                    steps=[
                        RequestRecord(
                            input_tokens=s[0],
                            output_tokens=s[1],
                            tool_duration_s=s[2],
                            reasoning_wall_s=s[3],
                            tool_kind=s[4],
                        )
                        for s in d["steps"]
                    ],
                )
            )
    return out
