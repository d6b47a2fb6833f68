"""Parse-quality A/B: device-full encoder (greedy + windowed-DP q11 tier)
vs the native q11 encoder, per corpus kind — the BASELINE.md "device DP
vs native q11" table generator.

Runs on the CPU backend (ratio is backend-independent; compiles are
cached by jaxcache). Every emitted stream is roundtripped through the
scalar oracle decoder before its size counts.

Usage: [AB_KB=400] JAX_PLATFORMS=cpu python tools/ab_parse.py
"""
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from brotlig_tpu.utils import jaxcache  # noqa: E402

jaxcache.enable()


def main():
    from test_roundtrip import make_data
    from brotlig_tpu import native
    from brotlig_tpu.ops.encode_pack import encode_stream_device_full
    from brotlig_tpu.refimpl.codec import decode as oracle_decode

    kb = int(os.environ.get("AB_KB", "400"))
    kinds = ["text", "structured", "repetitive"]
    rows = []
    tot_dev = tot_nat = tot_greedy = tot_in = 0
    for kind in kinds:
        data = make_data(kind, kb * 1024, seed=123)
        nat = native.encode(data, page_size=65536)
        dev = encode_stream_device_full(data, page_size=65536, quality=11)
        grd = encode_stream_device_full(data, page_size=65536, quality=1)
        assert oracle_decode(dev) == data, f"{kind}: device stream corrupt"
        rows.append({"kind": kind, "greedy": len(grd), "dp": len(dev),
                     "native_q11": len(nat),
                     "dp_vs_native_pct":
                         round((len(dev) / len(nat) - 1) * 100, 2)})
        tot_dev += len(dev)
        tot_nat += len(nat)
        tot_greedy += len(grd)
        tot_in += len(data)
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({
        "kind": "TOTAL", "greedy": tot_greedy, "dp": tot_dev,
        "native_q11": tot_nat,
        "dp_vs_native_pct": round((tot_dev / tot_nat - 1) * 100, 2),
        "dp_ratio": round(tot_in / tot_dev, 3),
        "native_ratio": round(tot_in / tot_nat, 3)}), flush=True)


if __name__ == "__main__":
    main()
