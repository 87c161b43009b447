"""Model FLOPs of the Modal Adapter, the gene mixer and the heads, for one
(slide, task) row: every product of the forward, 2 flop a multiply-add;
attention over its unmasked (query, key) pairs; no elementwise work."""

from __future__ import annotations


def mm(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def gene_mixer(config: dict) -> int:
    g = config["model"]["gene"]
    genes = config["genes"]
    d = config["model"]["backbone"]["embed_dim"]
    n, m, lat = genes["n_pathways"], genes["max_pathway"], g["latent_dim"]
    token = int(n * g["expansion_groups"])
    chan = int(lat * g["expansion_dim"])
    mix = 2 * mm(n, token, lat) + 2 * mm(n, lat, chan)
    return (n * mm(1, m, lat) + n * mm(1, lat, lat) + g["depth"] * mix
            + mm(n, lat, d) + mm(n, g["final_groups"], d))


def adapter(config: dict, n_img: int) -> int:
    """The interactions, prompt self-attentions, task token and fusion over
    ``n_img`` valid image tokens."""
    a = config["model"]["adapter"]
    d = config["model"]["backbone"]["embed_dim"]
    inner = int(d * a["cffn_ratio"])
    modal = config["model"]["gene"]["final_groups"] + 1
    inj = (mm(n_img, d, inner) + 2 * mm(n_img, inner, inner)
           + 2 * mm(modal, d, inner) + 4 * n_img * modal * inner
           + mm(n_img, inner, d))
    ext = (mm(modal, d, inner) + 2 * mm(modal, inner, inner)
           + 2 * mm(n_img, d, inner) + 4 * modal * n_img * inner
           + mm(modal, inner, d) + 2 * mm(modal, d, inner))
    psa = (mm(modal, d, inner) + 2 * mm(modal, inner, inner)
           + 2 * mm(modal, d, inner) + 4 * modal * modal * inner
           + mm(modal, inner, d))
    n_int = len(a["interaction_indexes"])
    n_cat = 1 if a["token_agg"] == "sum" else 3
    return (n_int * (inj + ext) + (2 * ext if a["use_extra_extractor"] else 0)
            + (n_int - 1) * psa + mm(1, a["multi_task"], d)
            + mm(1, d * n_cat, a["output_dim"]))


def trainable(config: dict, n_img: int) -> int:
    return gene_mixer(config) + adapter(config, n_img)
