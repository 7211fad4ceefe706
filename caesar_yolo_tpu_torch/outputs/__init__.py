"""Output writers: JSON catalogs and DS9 regions."""
