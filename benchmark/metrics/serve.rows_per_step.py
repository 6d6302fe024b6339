"""Sentences answered in the traced serving window over the device steps
the Corrector ran meanwhile (the increments of ``Corrector.steps``): how
many rows the cross-request batcher put in a step."""


def read(obs):
    if not obs.get("serve") or not obs["device_steps"]:
        return None
    return obs["sentences"] / obs["device_steps"]
