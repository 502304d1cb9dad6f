"""Data for training and for the paper's estimators (:mod:`.pipeline`)."""
