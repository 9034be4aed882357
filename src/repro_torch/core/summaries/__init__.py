"""Series summaries: PAA, SAX, EAPCA and DFT."""
