"""Extraction pipeline: video -> flow and rgb ticks -> TSN -> feature CSVs."""
