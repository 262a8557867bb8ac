"""Corpus formats, top-k primitives and the search engine."""
