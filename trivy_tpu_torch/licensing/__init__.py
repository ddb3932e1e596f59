"""License scanning: the corpus, name normalization and categories, the
n-gram classifier and the fused gate on the secret feed's rows."""
