"""bench subpackage: the JAX bench's rows timed through the port's entry
points (``python -m hmm_fasta_viterbi_tpu_torch.bench``)."""
