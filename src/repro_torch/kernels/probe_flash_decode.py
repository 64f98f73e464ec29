"""Time other builds of the flash-decode pair beside the shipped one.

A probe, not a path of the port.  It times what ``chip_smoke.py``'s
kernels line does not, by the same clock and on the same inputs:

* the shipped kernels built with another value of a constant of
  ``csrc/flash_decode.cu`` (``kStages``, the ring depth, or ``kTarget``,
  the block target of the split rule, which the wrapper then follows);
* the flash-decode pair of another checkout of the port (``src=DIR``,
  e.g. the ``src`` of a ``git archive`` of an earlier commit).

Each variant runs in a process of its own, in the order given (so that
one library and one rule are loaded at a time), holds the pair to its
plain version at each shape of ``chip_smoke.DECODE_SHAPES`` to
``chip_smoke.bf16_hold``'s limit, and prints one JSON line: device times
(``chip_smoke.device_ms``) of split + combine and of the split alone.
On one card:

    python3 src/repro_torch/kernels/probe_flash_decode.py \\
        src=OLD/src shipped kStages=2 kTarget=528 shipped src=OLD/src

writes the lines also to ``chiprun_out/probe_flash_decode.jsonl``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
#: constants of csrc/flash_decode.cu a variant may set
CONSTANTS = ("kStages", "kTarget")


def parse(spec: str) -> dict:
    """``"shipped"``, ``"src=DIR"`` or ``"kStages=2,kTarget=528"``."""
    if spec == "shipped":
        return {}
    out = dict(part.split("=", 1) for part in spec.split(","))
    bad = set(out) - {"src", *CONSTANTS}
    if bad or ("src" in out and len(out) > 1):
        raise ValueError(f"variant {spec!r}: src=DIR alone, or constants of "
                         f"{CONSTANTS}")
    return out


def run_one(spec: str) -> dict:
    """Time one variant in this process."""
    var = parse(spec)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [var.get("src", str(ROOT / "src")), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, flash_decode as fdk

    consts = {k: int(v) for k, v in var.items() if k in CONSTANTS}
    if consts:  # the shipped source with these constants, built apart
        text = (_build.CSRC / "flash_decode.cu").read_text()
        for name, value in consts.items():
            text, n = re.subn(rf"(constexpr int {name} = )\d+;",
                              rf"\g<1>{value};", text)
            if n != 1:
                raise RuntimeError(f"no constant {name} in flash_decode.cu")
        work = _build.BUILD_DIR / "probe" / spec.replace(",", "_")
        work.mkdir(parents=True, exist_ok=True)
        (work / "flash_decode.cu").write_text(text)
        _build.CSRC = _build.BUILD_DIR = work
        fdk.TARGET_BLOCKS = consts.get("kTarget", fdk.TARGET_BLOCKS)

    device = torch.device("cuda", 0)
    H, Hkv, d = cs.DECODE_HEADS
    gen = torch.Generator(device).manual_seed(5)  # decode_entries' inputs
    shapes = {}
    for label, B, T, n in cs.DECODE_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16) for shape in ((B, H, d), (B, T, Hkv, d),
                                          (B, T, Hkv, d)))
        lens = torch.tensor(n, dtype=torch.int32, device=device)
        err, lim = cs.bf16_hold(fdk.decode_attention(q, k, v, lens),
                                fdk.decode_attention_plain(q, k, v, lens))
        cs.check(err <= lim, f"{spec} at {label}: error {err} > {lim}")
        shapes[label] = {
            "ms": cs.device_ms(lambda: fdk.decode_attention(q, k, v, lens),
                               50, device),
            "split_ms": cs.device_ms(lambda: fdk.launch_split(q, k, v, lens),
                                     50, device),
            "max_abs_err": err, "limit": lim,
            "shape": {"B": B, "T": T, "cache_len": n, "H": H, "Hkv": Hkv,
                      "d": d, "dtype": "bfloat16"}}
        del q, k, v
    return {"variant": spec, "card": cs.card_line(), "shapes": shapes}


def main(argv: list) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(run_one(argv[1])), flush=True)
        return 0
    for spec in argv:
        parse(spec)
    out = ROOT / "chiprun_out" / "probe_flash_decode.jsonl"
    out.parent.mkdir(exist_ok=True)
    failed = 0
    with out.open("w") as f:
        for spec in argv or ["shipped"]:
            proc = subprocess.run([sys.executable, __file__, "--one", spec],
                                  capture_output=True, text=True)
            line = proc.stdout.strip().splitlines()[-1:] if \
                proc.returncode == 0 else []
            if not line:
                failed += 1
                line = [json.dumps({"variant": spec, "rc": proc.returncode,
                                    "stderr": proc.stderr[-2000:]})]
            print(line[0], flush=True)
            f.write(line[0] + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
