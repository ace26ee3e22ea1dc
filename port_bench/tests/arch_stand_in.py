"""A stand-in reference module that defines every architecture hook
(:mod:`port_bench.spec`), for the tests: a decoder whose first
``num_dense_layers`` layers have a dense MLP and the rest experts of width
``moe_intermediate_size`` beside ``num_shared_experts`` shared ones, with
``layer_types`` mixing sliding-window (``sliding_window``) and full causal
attention, at the published ``head_dim``.  It holds no reference model:
only the shapes and the work the harness asks about."""
from port_bench.flops import attended_pairs

ARCH_KEYS = {
    "moe_intermediate_size": 0,
    "num_shared_experts": 0,
    "num_dense_layers": 0,
    "layer_types": [],
    "sliding_window": 0,
    # run keys: the port's ModelConfig has ``window``, not ``dense_first``
    "window": 0,
    "dense_first": False,
}


def _counts(m):
    dense = m.arch["num_dense_layers"]
    return dense, m.n_layers - dense


def leaf_specs(m):
    d, ff, ef = m.d_model, m.d_ff, m.arch["moe_intermediate_size"]
    sf = ef * m.arch["num_shared_experts"]
    q, kv = m.n_heads * m.head_dim, m.n_kv_heads * m.head_dim
    dense, sparse = _counts(m)
    L, e = m.n_layers, m.n_experts
    return [("embed", (m.vocab_size, d), d),
            ("lm_head", (d, m.vocab_size), d),
            ("layers/attn/wq", (L, d, q), d),
            ("layers/attn/wk", (L, d, kv), d),
            ("layers/attn/wv", (L, d, kv), d),
            ("layers/attn/wo", (L, q, d), q),
            ("dense/mlp/w_gate", (dense, d, ff), d),
            ("dense/mlp/w_up", (dense, d, ff), d),
            ("dense/mlp/w_down", (dense, ff, d), ff),
            ("moe/router", (sparse, d, e), d),
            ("moe/w_gate", (sparse, e, d, ef), d),
            ("moe/w_up", (sparse, e, d, ef), d),
            ("moe/w_down", (sparse, e, ef, d), ef),
            ("moe/shared/w_gate", (sparse, d, sf), d),
            ("moe/shared/w_up", (sparse, d, sf), d),
            ("moe/shared/w_down", (sparse, sf, d), sf),
            ("final_norm", None, 0)]


def _pairs(m, kind, s):
    window = m.arch["sliding_window"] if kind == "sliding_attention" else 0
    return attended_pairs(s, True, window)


def forward_flops(m, b, s):
    d, ff, ef = m.d_model, m.d_ff, m.arch["moe_intermediate_size"]
    dense, sparse = _counts(m)
    attn = 2 * d * (m.n_heads + m.n_kv_heads) * m.head_dim
    moe = d * m.n_experts + (m.top_k + m.arch["num_shared_experts"]) \
        * 3 * d * ef
    params = m.n_layers * attn + dense * 3 * d * ff + sparse * moe \
        + d * m.vocab_size
    mixing = sum(4 * b * m.n_heads * _pairs(m, kind, s) * m.head_dim
                 for kind in m.arch["layer_types"])
    return 2 * b * s * params + mixing


def attention_layers(m, b, s):
    h, kv, hd = m.n_heads, m.n_kv_heads, m.head_dim
    out = []
    for kind in m.arch["layer_types"]:
        pairs = _pairs(m, kind, s)
        fwd = (4 * b * h * pairs * hd,
               2 * (2 * b * h * s * hd + 2 * b * kv * s * hd) + 4 * b * h * s)
        bwd = (10 * b * h * pairs * hd,
               2 * (4 * b * h * s * hd + 4 * b * kv * s * hd) + 4 * b * h * s)
        out.append((fwd, bwd))
    return out


def moe_layers(m):
    return _counts(m)[1]
