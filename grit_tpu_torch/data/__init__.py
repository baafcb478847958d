"""Caption text fields, vocabulary, tokenizer and image transforms (the port's
own copies of the JAX package's jax-free modules)."""
