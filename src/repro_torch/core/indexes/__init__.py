"""Index builders: iSAX2+, DSTree and VA+file."""
