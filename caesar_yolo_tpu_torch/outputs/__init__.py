"""Output writers: JSON catalogs, DS9 regions and detection plots."""
