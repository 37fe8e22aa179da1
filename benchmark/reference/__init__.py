"""The plain reference of the benchmark's cells: PyTorch and NumPy only.

It imports neither the JAX package nor anything of the port, and takes
nothing the program made: the benchmark hands it the same inputs (weights,
fill rows, batches, requests) that it hands the program, made from the seed.

A configuration names its module under `reference`; the module gives

  leaf_specs(model)        (shape, std) of each tower leaf, in the order the
                           port's `weights.from_jax_params` takes them
  macs_per_example(model)  multiply-adds of one example's forward pass
  init_rows(ids, dim, scale)  the table's rows of first sightings
  precision(kind)          a context: "float32" (TF32 off) or "tf32"
  train(model, table, dense_opt, leaves, batches, start_rows, device, kind)
  score(model, leaves, dense, emb, lengths=None)

as `dlrm.py` documents them. Batches and requests of multi-hot bags come
as ragged ids or rows with their lengths [B, S], which the module pools by
the model's `combiner`.
"""
