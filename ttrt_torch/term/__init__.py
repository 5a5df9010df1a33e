"""Terminal backend: on-device ANSI truecolor encoding + host display."""
