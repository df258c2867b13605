"""Pickles, windows, standardization, categories, synthetic fixtures, and the
raw-data entry: OpenPose JSON ingestion, text ids and dataset assembly
(numpy only)."""
