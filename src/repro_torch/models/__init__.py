"""Model families; the CNN family of the paper is ported."""
