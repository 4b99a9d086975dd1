"""TPU704 fixture: a typo'd channel subscription and a raw push
handler that never unpacks coalesced batch frames."""


class Bus:
    def publish(self, channel, msg):
        del channel, msg

    def subscribe(self, channel, handler):
        del channel, handler


def _render(payload):
    return payload["msg"]


def wire(bus, client):
    bus.publish("metrics", {"v": 1})
    bus.subscribe("metrics", _render)
    bus.subscribe("metrcis", _render)
    client.connect(on_push=_render)
