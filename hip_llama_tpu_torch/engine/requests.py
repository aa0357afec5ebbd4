"""Request batch I/O — file contract parity with the reference
(src/llama.cpp:424-505): input = first line request count then one prompt per
line; output = count then one generation per line (each generation already
carries a trailing newline appended at retirement, llama.cpp:1056-1058)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Requests:
    prompts: list[str]
    generations: list[str]

    @property
    def num_reqs(self) -> int:
        return len(self.prompts)


def read_inputfile(path: str) -> Requests:
    with open(path, "r", errors="replace") as f:
        first = f.readline()
        num = int(first.strip())
        prompts = []
        for _ in range(num):
            line = f.readline()
            if not line:
                break
            prompts.append(line.rstrip("\n"))
    return Requests(prompts=prompts, generations=[""] * len(prompts))


def write_outputfile(path: str, reqs: Requests) -> None:
    with open(path, "w") as f:
        f.write(f"{reqs.num_reqs}\n")
        for g in reqs.generations:
            f.write(g + "\n")
