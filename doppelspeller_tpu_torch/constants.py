"""Training-pair provenance codes (the JAX package's ``constants.py``; its
data-type tags and dataframe column names come with the CLI verbs)."""

TRAINING_KIND_GENERATED = 1
TRAINING_KIND_NEGATIVE = 2
TRAINING_KIND_POSITIVE = 3
