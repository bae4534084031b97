"""The learner's networks (``nets``) and the reader that carries flax
weights across (``convert``)."""
