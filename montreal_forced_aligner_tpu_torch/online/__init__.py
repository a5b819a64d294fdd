"""Single-utterance alignment."""
