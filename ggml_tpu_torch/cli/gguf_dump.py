#!/usr/bin/env python
"""gguf_dump — inspect GGUF files: metadata KVs + tensor table (the port's
own copy of ggml_tpu/cli/gguf_dump.py, over the port's reader).

The gguf ecosystem's `gguf-dump` analog (reference format spec:
docs/gguf.md; reader: src/gguf.cpp:319).

Usage:
  python -m ggml_tpu_torch.cli.gguf_dump model.gguf                # KVs + tensor summary
  python -m ggml_tpu_torch.cli.gguf_dump model.gguf --no-tensors   # KVs only
  python -m ggml_tpu_torch.cli.gguf_dump model.gguf --json         # machine-readable
"""

import argparse
import json

from ggml_tpu_torch.gguf import GGUFFile


def _py(v):
    """numpy scalars/arrays (the reader's zero-copy array KVs) -> plain python"""
    if hasattr(v, "tolist"):
        return v.tolist()
    if isinstance(v, list):
        return [_py(x) for x in v]
    return v


def _fmt_val(v, maxlen=80):
    v = _py(v)
    if isinstance(v, list):
        s = json.dumps(v[:8])
        return f"[{len(v)}] {s[:maxlen]}{'...' if len(v) > 8 or len(s) > maxlen else ''}"
    s = str(v)
    return s[:maxlen] + ("..." if len(s) > maxlen else "")


def dump(path: str, show_tensors: bool = True, as_json: bool = False) -> dict:
    g = GGUFFile(path)
    try:
        info = {
            "path": g.path,
            "version": g.version,
            "alignment": g.alignment,
            "n_kv": len(g.metadata),
            "n_tensors": len(g.tensors),
            "data_offset": g.data_offset,
            "metadata": {
                k: (v if not isinstance(v, list) or len(v) <= 16 else
                    {"len": len(v), "head": v[:8]})
                for k, v in ((k, _py(v)) for k, v in g.metadata.items())
            },
            "tensors": [
                {
                    "name": t.name,
                    "shape": list(t.shape),
                    "type": t.ggml_type.name,
                    "offset": t.offset,
                    "bytes": t.n_bytes,
                }
                for t in g.tensors.values()
            ],
        }
        if as_json:
            print(json.dumps(info, indent=1))
            return info
        total = sum(t.n_bytes for t in g.tensors.values())
        print(f"{g.path}: GGUF v{g.version}, {len(g.metadata)} KVs, "
              f"{len(g.tensors)} tensors, {total / 1e6:.2f} MB data, "
              f"alignment {g.alignment}")
        print("\n-- metadata --")
        for k, v in g.metadata.items():
            print(f"  {k} = {_fmt_val(v)}")
        if show_tensors:
            print("\n-- tensors --")
            by_type: dict[str, int] = {}
            for t in g.tensors.values():
                by_type[t.ggml_type.name] = by_type.get(t.ggml_type.name, 0) + 1
                shape = "x".join(map(str, t.shape))
                print(f"  {t.name:48s} {shape:>20s} {t.ggml_type.name:8s} {t.n_bytes:>12d} B")
            summary = ", ".join(f"{n} {ty}" for ty, n in sorted(by_type.items()))
            print(f"\n  ({summary})")
        return info
    finally:
        g.close()


def parser() -> argparse.ArgumentParser:
    """The dump's flags; it reads the file on the host and needs no device."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path")
    ap.add_argument("--no-tensors", action="store_true")
    ap.add_argument("--json", action="store_true")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dump(args.path, show_tensors=not args.no_tensors, as_json=args.json)


if __name__ == "__main__":
    main()
