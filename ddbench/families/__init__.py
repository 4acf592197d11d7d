"""Instance families: `<family>.py` draws an instance's arrays and hands them
to the port; `<family>_ref.py` is its plain reference, which imports
nothing of the port."""
