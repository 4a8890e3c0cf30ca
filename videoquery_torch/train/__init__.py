"""See videoquery_torch/__init__.py; this package imports nothing eagerly."""
