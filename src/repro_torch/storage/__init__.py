"""Storage device models (the persistent heap and WAL come with the
persistence slice)."""
