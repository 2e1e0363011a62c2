"""The decode-vs-prefill contract of zamba2's layout, in the reference and
in the port, on one set of weights (CPU, f32).

The contract -- one decode step per token from an empty cache ends on the
prefill's last logits -- holds only up to f32 rounding, and random weights
amplify that rounding.  `chip_smoke.py` holds the port to it at zamba2-7b's
full width on the first 13 layers, within CONTRACT_RTOL of the logits'
largest magnitude.  These tests measure the same error in both packages at
a narrower width (13 layers, 2 x 512 tokens: two SSD chunks, two
shared-attention sites) beside the reference's one-ulp sensitivity (how far
its logits move when every embedding entry moves by one f32 ulp), hold both
packages to that limit, and hold the port to a few times the reference's
own rounding.  (At d_model 128 all are 6e-5 to 3e-4; at 256 the
reference's decode error is 3.7e-3: the amplification depends on the
weights, not on width alone.)

Run as a script, the file measures the same at any width; at
zamba2-7b's full width (13 layers: about 5.5 GB of f32 weights in each
package, minutes of CPU time) it is the reference's witness for the limit
used on the card:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_decode_contract.py \\
        --d-model 3584 --n-heads 32 --vocab 32000
"""
from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import hybrid as jhybrid
from repro.models.registry import get_model as j_get_model
import repro_torch.configs as pconfigs
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_numpy

CONTRACT_RTOL = 5e-3     # chip_smoke.py's limit, relative to max |logit|
LAYERS = 13
SEQ = 512


def contract_errors(d_model: int, n_heads: int = 4,
                    vocab: int = 1024) -> dict:
    """Max abs error of the last logits after SEQ decode steps against a
    prefill of 2 x SEQ tokens, in the reference and in the port on the
    reference's weights, beside the reference's one-ulp sensitivity;
    zamba2-7b's layout, LAYERS deep, with the width, heads and vocab given
    (d_ff = 4 d_model, heads 112 wide)."""
    seq = SEQ
    kw = dict(n_layers=LAYERS, d_model=d_model, n_heads=n_heads,
              n_kv_heads=n_heads, d_ff=4 * d_model, vocab=vocab,
              compute_dtype="float32", remat=False)
    jcfg = jconfigs.get_config("zamba2-7b").replace(**kw)
    tokens = np.random.default_rng(0).integers(0, vocab, (2, seq),
                                               dtype=np.int32)
    jmodel = j_get_model(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    j_full = np.asarray(jhybrid.hybrid_logits(jcfg, jp, tokens,
                                              last_only=True))
    jcache = jmodel.init_cache(2, seq)
    step = jax.jit(jmodel.decode_step)
    for t in range(seq):
        j_dec, jcache = step(jp, jcache, tokens[:, t:t + 1], jnp.int32(t))
    j_dec = np.asarray(j_dec)
    # the rounding noise the network amplifies: the reference's prefill
    # again with every embedding entry moved by at most one f32 ulp
    bumped = dict(jp, embed=dict(jp["embed"], tok=jp["embed"]["tok"]
                                 * (1.0 + 2.0 ** -23)))
    j_bump = np.asarray(jhybrid.hybrid_logits(jcfg, bumped, tokens,
                                              last_only=True))
    del bumped
    err = lambda a, b: float(np.abs(a - b).max())  # noqa: E731
    out = {"d_model": d_model, "n_layers": LAYERS, "seq": seq,
           "max_abs_logit": float(np.abs(j_full).max()),
           "reference": err(j_dec, j_full),
           "reference_ulp": err(j_bump, j_full)}
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    del jp, jcache
    model = get_model(pconfigs.get_config("zamba2-7b").replace(**kw))
    tt = torch.tensor(tokens, dtype=torch.int64)
    p_full = model.prefill(params, {"tokens": tt}).numpy()
    cache = model.init_cache(2, seq, device="cpu")
    for t in range(seq):
        p_dec, cache = model.decode_step(params, cache, tt[:, t:t + 1], t)
    p_dec = p_dec.numpy()
    out.update(port=err(p_dec, p_full),
               prefill_port_vs_reference=err(p_full, j_full),
               decode_port_vs_reference=err(p_dec, j_dec))
    return out


def test_reference_and_port_meet_the_contract_alike():
    """At d_model 256 the reference's own decode misses its prefill by
    3.7e-3 on logits of 1.1 (3.4e-3 of their scale) and one ulp on the
    embedding moves its logits by 1.8e-3; the port's decode misses by
    2.2e-4.  Errors of the size the card's limit allows arise in the
    reference itself."""
    torch.set_num_threads(1)
    e = contract_errors(256)
    limit = CONTRACT_RTOL * e["max_abs_logit"]
    rounding = max(e["reference"], e["reference_ulp"])
    # neither package's decode reproduces its prefill bit for bit ...
    assert 0.0 < e["reference"] <= limit, e
    assert 0.0 < e["port"] <= limit, e
    # ... and the port differs from itself and from the reference by no
    # more than a few times the reference's own rounding
    for key in ("port", "prefill_port_vs_reference",
                "decode_port_vs_reference"):
        assert e[key] <= 4.0 * rounding, (key, e)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=1024)
    args = ap.parse_args()
    e = contract_errors(args.d_model, args.n_heads, args.vocab)
    for k in ("reference", "reference_ulp", "port"):
        e[f"{k}_rel"] = e[k] / e["max_abs_logit"]
    print(json.dumps(e))


if __name__ == "__main__":
    main()
