"""Performance-variant flags: the port of ``repro.models.perfcfg``.

Module state, as in the reference: a process's flags hold for every
forward it runs until they are set again, so each rank of a mesh sets
its own (the rank harnesses pass the variant to every rank they spawn).
The dry run (``launch/dryrun.py``) sets them from ``--variant``.

  router_bf16_matmul  (default on): the MoE router as a matmul of x and
      the router rounded to x's dtype with f32 sums, where off it is
      x in f32 times the f32 router (``models/moe.py``: ``route``).
  sp_residual: the residual stream stays sharded over ``model`` along the
      sequence between blocks, where the sequence splits there
      (``models/transformer.py``): the norms and residual adds run on the
      rank's rows, each column-parallel entry gathers the rows and each
      row-parallel exit reduce-scatters them.
  banded_local: gemma3's local layers as O(S·w) banded attention. B4's
      windowed instance already starts each query tile's key loop at the
      band's first tile, so on the port the flag changes no work
      (ROADMAP C29).
  seq_shard_attn: where the q heads do not divide ``model``, each rank
      attends for its block of the query rows over the keys up to its
      last row (B4 at a causal query offset), in place of every rank
      computing every head's attention.
  a2a_int8: the MoE dispatch's rows sent out and sent back quantized to
      int8 per row, with their f32 scales as a second exchange.
"""
_FLAGS = {
    "router_bf16_matmul": True,
    "sp_residual": False,
    "banded_local": False,
    "seq_shard_attn": False,
    "a2a_int8": False,
}

VARIANTS = {
    "base": {},
    "spresid": {"sp_residual": True},
    "banded": {"banded_local": True, "seq_shard_attn": True},
    "seqattn": {"seq_shard_attn": True},
    "a2aint8": {"sp_residual": True, "a2a_int8": True},
    "compressed": {},   # int8 pod-axis gradient all-reduce (dryrun --compress)
    "allopt": {"sp_residual": True, "banded_local": True,
               "seq_shard_attn": True, "a2a_int8": True},
    "paperfaithful": {"router_bf16_matmul": False},
}


def set_flags(**kw):
    for k, v in kw.items():
        if k not in _FLAGS:
            raise KeyError(f"no perf flag {k!r}; the flags: {tuple(_FLAGS)}")
        _FLAGS[k] = v


def set_variant(name: str):
    reset()
    set_flags(**VARIANTS[name])


def reset():
    _FLAGS.update(router_bf16_matmul=True, sp_residual=False,
                  banded_local=False, seq_shard_attn=False, a2a_int8=False)


def flag(name: str) -> bool:
    return _FLAGS[name]
